"""The port's twin of ``tests/test_cp_failover_chaos.py``, case for case,
with the two name moves (``ray_tpu`` → ``ray_tpu_torch``, ``RAY_TPU_`` →
``RAY_TPU_TORCH_``).

Control-plane leader kill -9 under LIVE traffic.

The HA acceptance scenario (docs/ha.md): a training actor keeps
stepping and a serve-style request loop keeps resolving + calling a
named actor while the leader is SIGKILLed.  The warm standby must take
over within the bounded window with zero dropped requests, no lost
PENDING work, and no double-charged quota — clients re-anchor through
their resolver-backed retry loops, never through test plumbing.

Fast single-failover run is tier-1; the repeated-failover soak is
``@slow``.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.devtools.chaos import KilledLeader

pytestmark = pytest.mark.chaos

FAILOVER_WINDOW_S = 20.0


@pytest.fixture
def ha_cluster():
    ctx = ray_tpu_torch.init(
        num_cpus=4,
        job_quota={"CPU": 8},
        _system_config={
            "cp_ha": 1,
            "cp_lease_ttl_s": 1.0,
            "cp_lease_poll_s": 0.1,
        },
    )
    yield ctx
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Trainer:
    def __init__(self):
        self.steps = 0

    def step(self):
        self.steps += 1
        return self.steps


@ray_tpu_torch.remote
class Echo:
    def ping(self, x):
        return x


class _Traffic:
    """Two closed loops: train steps (worker-direct after the first
    resolve) and serve-style requests that re-resolve the named actor
    through the control plane EVERY iteration — the loop that feels a
    leaderless window if re-anchor ever drops a request."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.train_steps = 0
        self.serve_ok = 0
        self.errors = []
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._train_loop, daemon=True,
                             name="chaos-train"),
            threading.Thread(target=self._serve_loop, daemon=True,
                             name="chaos-serve"),
        ]

    def _train_loop(self):
        while not self._stop.is_set():
            try:
                self.train_steps = ray_tpu_torch.get(
                    self.trainer.step.remote(), timeout=60
                )
            except Exception as e:  # noqa: BLE001 — recorded, asserted == 0
                self.errors.append(f"train: {e!r}")
                return

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                h = ray_tpu_torch.get_actor("chaos-echo")
                assert ray_tpu_torch.get(
                    h.ping.remote(self.serve_ok), timeout=60
                ) == self.serve_ok
                self.serve_ok += 1
            except Exception as e:  # noqa: BLE001 — recorded, asserted == 0
                self.errors.append(f"serve: {e!r}")
                return

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)


def _scheduling_usage(w):
    sched = w._run_sync(w.cp.call("get_state"))["scheduling"]
    job_hex = w.job_id.hex()
    row = sched.get(job_hex) or {}
    return {k: v for k, v in (row.get("usage") or {}).items() if v > 1e-9}


def test_failover_under_live_traffic(ha_cluster):
    from ray_tpu_torch.api import global_worker

    w = global_worker()
    node = api._local_node

    trainer = Trainer.remote()
    Echo.options(name="chaos-echo").remote()
    assert ray_tpu_torch.get(trainer.step.remote(), timeout=60) == 1

    # Durable work the failover must NOT lose: a quota-charged CREATED
    # group and a PENDING actor waiting for capacity.
    pg = ray_tpu_torch.placement_group([{"CPU": 1}])
    assert pg.ready(timeout=60)
    pending = Trainer.options(num_cpus=64, name="ha-pending").remote()  # noqa: F841
    time.sleep(1.0)
    usage_before = _scheduling_usage(w)
    assert usage_before.get("CPU", 0) >= 1.0  # the PG's charge is live

    with _Traffic(trainer) as traffic:
        # Let both loops prove themselves before the fault.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
            traffic.serve_ok < 3 or traffic.train_steps < 3
        ):
            time.sleep(0.05)
        assert traffic.serve_ok >= 3 and traffic.train_steps >= 3
        steps_pre = traffic.train_steps
        serve_pre = traffic.serve_ok

        with KilledLeader(node) as kl:
            t0 = time.monotonic()
            node.wait_for_failover(kl.old_epoch, timeout=FAILOVER_WINDOW_S)
            assert time.monotonic() - t0 < FAILOVER_WINDOW_S
            # Traffic keeps flowing THROUGH the new leader.
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and (
                traffic.serve_ok < serve_pre + 3
                or traffic.train_steps < steps_pre + 3
            ):
                if traffic.errors:
                    break
                time.sleep(0.05)

    assert traffic.errors == []
    assert traffic.train_steps > steps_pre, "train loop stalled"
    assert traffic.serve_ok > serve_pre, "serve loop dropped requests"

    # No double-charged quota: the re-derived arbiter charge matches.
    assert _scheduling_usage(w) == usage_before
    # No lost PENDING work: the queued actor survived as PENDING.
    info = w._run_sync(
        w.cp.call("get_named_actor", {"namespace": "", "name": "ha-pending"})
    )
    assert info is not None
    # The created group is still CREATED and usable.
    pg_info = w._run_sync(
        w.cp.call("get_placement_group", {"pg_id": pg.id})
    )
    assert pg_info["state"] == "CREATED"
    assert node.leader_epoch() > kl.old_epoch


@pytest.mark.slow
def test_repeated_failover_soak(ha_cluster):
    """Four consecutive leader kills under sustained traffic: every
    failover re-elects within the window, requests never drop, and the
    journal-recovered state stays consistent."""
    from ray_tpu_torch.api import global_worker

    w = global_worker()
    node = api._local_node

    trainer = Trainer.remote()
    Echo.options(name="chaos-echo").remote()
    assert ray_tpu_torch.get(trainer.step.remote(), timeout=60) == 1
    pg = ray_tpu_torch.placement_group([{"CPU": 1}])
    assert pg.ready(timeout=60)
    usage_before = _scheduling_usage(w)

    epochs = [node.leader_epoch()]
    with _Traffic(trainer) as traffic:
        for round_no in range(4):
            w.kv_put("soak", f"round-{round_no}", str(round_no).encode())
            serve_pre = traffic.serve_ok
            with KilledLeader(node) as kl:
                node.wait_for_failover(
                    kl.old_epoch, timeout=FAILOVER_WINDOW_S
                )
                epochs.append(node.leader_epoch())
                deadline = time.monotonic() + 60
                while (time.monotonic() < deadline
                       and traffic.serve_ok < serve_pre + 2):
                    if traffic.errors:
                        break
                    time.sleep(0.05)
            # KilledLeader.revert respawned a standby; give it a beat to
            # warm before the next kill so every round is a WARM failover.
            from ray_tpu_torch.core.cp_ha import read_standby_statuses

            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and not read_standby_statuses(node.ha_dir)):
                time.sleep(0.1)

    assert traffic.errors == []
    assert epochs == sorted(set(epochs)), f"epochs not increasing: {epochs}"
    assert _scheduling_usage(w) == usage_before
    for round_no in range(4):
        assert w.kv_get("soak", f"round-{round_no}") \
            == str(round_no).encode()
    pg_info = w._run_sync(
        w.cp.call("get_placement_group", {"pg_id": pg.id})
    )
    assert pg_info["state"] == "CREATED"
