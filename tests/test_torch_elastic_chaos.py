"""The port's twin of ``tests/test_elastic_chaos.py``, case for case, with
the two name moves (``ray_tpu`` → ``ray_tpu_torch``, ``RAY_TPU_`` →
``RAY_TPU_TORCH_``).

Chaos scenarios for elastic capacity (docs/elastic.md §Chaos coverage).

Provider faults injected through ``ray_tpu_torch.devtools.chaos`` drive the
REAL reconcile loop — no test hooks into the autoscaler:

- **ProviderCreateErrors**: a stockout converges to a slow, jittered
  retry cadence (the launch backoff), never a hot provider loop.
- **SlowProvisioning**: while a VM boots, its provider record counts as
  planned capacity — the same demand must not launch a second copy.
- **NodeChurn mid-drain**: a node killed behind the cloud API's back
  while draining still converges (health check + drain_status's
  dead-node short-circuit), and the provider record is reclaimed.

Fast subset is tier-1 (``chaos`` marker); the repeated churn cycle is
additionally ``slow``."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalingConfig,
    FakeMultiNodeProvider,
    NodeTypeConfig,
)
from ray_tpu_torch.autoscaler.provider import PROVIDER_ID_LABEL
from ray_tpu_torch.devtools import chaos

pytestmark = pytest.mark.chaos


def _mk(ctx, **cfg_kw):
    cp = ctx.address_info["cp_address"]
    provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
    defaults = dict(
        node_types={
            "worker4": NodeTypeConfig("worker4", {"CPU": 4.0}, max_workers=2)
        },
        idle_timeout_s=3600.0,  # scale-down only when a test asks for it
    )
    defaults.update(cfg_kw)
    return provider, Autoscaler(
        AutoscalingConfig(**defaults), provider, cp
    )


def _pid_to_hex(scaler):
    state = scaler._get_load_state()
    return {
        n.get("labels", {}).get(PROVIDER_ID_LABEL): nid
        for nid, n in state["nodes"].items()
    }


class TestElasticChaos:
    def test_provider_errors_backoff_not_hot_loop(self):
        ctx = ray_tpu_torch.init(num_cpus=1)
        provider = scaler = None
        try:
            provider, scaler = _mk(
                ctx, launch_backoff_base_s=0.4, launch_backoff_cap_s=1.5
            )

            @ray_tpu_torch.remote(num_cpus=4)
            class Big:
                def ping(self):
                    return "pong"

            h = Big.remote()
            time.sleep(1.0)

            with chaos.ProviderCreateErrors(provider, count=2):
                rounds = 0
                deadline = time.monotonic() + 3.0
                while time.monotonic() < deadline:
                    d = scaler.update()
                    rounds += 1
                    time.sleep(0.05)
            # Dozens of reconcile rounds hammered the loop; the backoff
            # gate kept actual provider calls bounded.
            assert rounds >= 10
            assert provider.create_calls <= 4
            assert d.launch_failures.get("worker4", 0) >= 1 \
                or provider.create_calls > 2

            # Errors exhausted: the next open gate launches for real and
            # the queued demand drains onto the node.
            deadline = time.monotonic() + 60
            while (
                time.monotonic() < deadline
                and not provider.non_terminated_nodes()
            ):
                scaler.update()
                time.sleep(0.3)
            assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
            assert scaler._backoffs["worker4"].consecutive_failures == 0
        finally:
            if provider is not None:
                provider.shutdown()
            if scaler is not None:
                scaler.stop()
            ray_tpu_torch.shutdown()

    def test_slow_provisioning_no_double_launch(self):
        ctx = ray_tpu_torch.init(num_cpus=1)
        provider = scaler = None
        try:
            provider, scaler = _mk(ctx, reclaim_grace_s=60.0)

            @ray_tpu_torch.remote(num_cpus=4)
            class Big:
                def ping(self):
                    return "pong"

            with chaos.SlowProvisioning(provider, delay_s=2.5):
                h = Big.remote()
                time.sleep(1.0)
                d = scaler.update()
                assert d.to_launch == {"worker4": 1}
                assert provider.create_calls == 1
                # Hammer the loop while the "VM" boots: the provisioning
                # record is planned capacity, the demand must not launch
                # a second copy.
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    scaler.update()
                    time.sleep(0.2)
                assert provider.create_calls == 1

            assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
            assert provider.create_calls == 1
        finally:
            if provider is not None:
                provider.shutdown()
            if scaler is not None:
                scaler.stop()
            ray_tpu_torch.shutdown()

    def test_node_churn_mid_drain_converges(self):
        ctx = ray_tpu_torch.init(num_cpus=1)
        provider = scaler = None
        try:
            provider, scaler = _mk(
                ctx, drain_timeout_s=30.0, reclaim_grace_s=5.0
            )

            # A long 4-CPU task holds the node busy so the drain cannot
            # complete instantly (tasks are not migrated, only awaited).
            @ray_tpu_torch.remote(num_cpus=4, max_retries=0)
            def hog():
                time.sleep(60)
                return 1

            ref = hog.remote()
            time.sleep(1.0)
            deadline = time.monotonic() + 60
            while (
                time.monotonic() < deadline
                and not provider.non_terminated_nodes()
            ):
                scaler.update()
                time.sleep(0.3)
            nodes = provider.non_terminated_nodes()
            assert len(nodes) == 1
            pid = next(iter(nodes))

            # Wait for the task's lease to make the node BUSY (available
            # != total), then start an explicit drain: a busy node keeps
            # the drain in flight instead of completing in one round.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                hexes = _pid_to_hex(scaler)
                state = scaler._get_load_state()
                node = next(
                    (
                        n for n in state["nodes"].values()
                        if n.get("labels", {}).get(PROVIDER_ID_LABEL) == pid
                    ),
                    None,
                )
                if (
                    hexes.get(pid)
                    and node is not None
                    and node["available"] != node["total"]
                ):
                    break
                time.sleep(0.3)
            scaler.drainer.request(
                pid, hexes[pid], cause="chaos: churn mid-drain"
            )
            scaler.update()
            assert scaler.drainer.is_draining(pid)
            assert pid in provider.non_terminated_nodes()

            # Kill the node behind the provider's back, mid-drain.
            with chaos.NodeChurn(provider, pid):
                deadline = time.monotonic() + 60
                while (
                    time.monotonic() < deadline
                    and provider.non_terminated_nodes()
                ):
                    scaler.update()
                    time.sleep(0.5)
            assert provider.non_terminated_nodes() == {}
            assert not scaler.drainer.is_draining(pid)
            # The dead node short-circuits drain_status (drained) — or,
            # had the health check been slower, the drain timeout: either
            # way the state machine retired it.
            assert (
                scaler.drainer.stats["drained"]
                + scaler.drainer.stats["timeout"]
            ) >= 1
            with pytest.raises(Exception):
                ray_tpu_torch.get(ref, timeout=5)
        finally:
            if provider is not None:
                provider.shutdown()
            if scaler is not None:
                scaler.stop()
            ray_tpu_torch.shutdown()


@pytest.mark.slow
class TestElasticChurnSoak:
    def test_repeated_churn_cycles_converge(self):
        """Three provision→churn→relaunch cycles: the actor migrates to
        each replacement node, stale records are reclaimed, and the
        cluster ends clean."""
        ctx = ray_tpu_torch.init(num_cpus=1)
        provider = scaler = None
        try:
            provider, scaler = _mk(
                ctx, idle_timeout_s=1.0, reclaim_grace_s=2.0,
                drain_timeout_s=15.0,
            )

            @ray_tpu_torch.remote(num_cpus=4, max_restarts=8)
            class Big:
                def ping(self):
                    return "pong"

            h = Big.remote()
            time.sleep(1.0)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                scaler.update()
                try:
                    assert ray_tpu_torch.get(h.ping.remote(), timeout=5) == "pong"
                    break
                except Exception:  # noqa: BLE001 — still provisioning
                    time.sleep(0.3)

            for cycle in range(3):
                victim = next(iter(provider.non_terminated_nodes()))
                with chaos.NodeChurn(provider, victim):
                    # Recovery is the system's job: health check marks the
                    # node dead, the restarting actor re-exports demand, a
                    # replacement launches, the stale record is reclaimed.
                    ok = False
                    deadline = time.monotonic() + 90
                    while time.monotonic() < deadline:
                        scaler.update()
                        try:
                            if ray_tpu_torch.get(
                                h.ping.remote(), timeout=5
                            ) == "pong" and victim not in \
                                    provider.non_terminated_nodes():
                                ok = True
                                break
                        except Exception:  # noqa: BLE001 — mid-recovery
                            pass
                        time.sleep(0.5)
                    assert ok, f"cycle {cycle}: actor never recovered"

            # End clean: kill the actor, the idle node drains away.
            ray_tpu_torch.kill(h)
            deadline = time.monotonic() + 60
            while (
                time.monotonic() < deadline
                and provider.non_terminated_nodes()
            ):
                scaler.update()
                time.sleep(0.5)
            assert provider.non_terminated_nodes() == {}
        finally:
            if provider is not None:
                provider.shutdown()
            if scaler is not None:
                scaler.stop()
            ray_tpu_torch.shutdown()
