"""The port's autoscaler against the JAX package's, on the CPU.

Every scheduler decision of ``tests/test_autoscaler.py`` runs through
``ray_tpu.autoscaler`` and ``ray_tpu_torch.autoscaler`` on one config that
holds a ``GPU`` node type beside the ``TPU`` one: the two decisions are
equal field for field, and hold what the JAX tests assert.
``LaunchBackoff``, ``NodeDrainer`` and the backoff-gated reconcile loop run
the JAX cases on the port.  In port clusters: a pending actor launches a
fake node that is drained away once idle, a standing request is absorbed,
and a ``num_gpus=1`` task with nothing to run it on launches a ``GPU``
node type, runs under ``CUDA_VISIBLE_DEVICES="0"`` and leaves the
cluster's ``GPU`` total at 0 after scale-down.  Then the port's own
divergences: a fake node registers a card only where its type names
``GPU`` (detection patched to report one), the default stop command
matches a port worker's command line and not its own shell, and
``GCEGPUProvider``'s ``gcloud`` command lines.
"""

import dataclasses
import inspect
import os
import re
import subprocess
import sys
import time

import pytest

import ray_tpu.autoscaler as jauto
import ray_tpu.autoscaler.elastic as jelastic
import ray_tpu.autoscaler.provider as jprovider
import ray_tpu.autoscaler.scheduler as jsched
import ray_tpu_torch
import ray_tpu_torch.autoscaler as tauto
import ray_tpu_torch.autoscaler.elastic as telastic
import ray_tpu_torch.autoscaler.provider as tprovider
import ray_tpu_torch.autoscaler.scheduler as tsched
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalingConfig,
    FakeMultiNodeProvider,
    NodeTypeConfig,
    request_resources,
)
from ray_tpu_torch.autoscaler.command_runner import ManagedVMProvider
from ray_tpu_torch.autoscaler.provider import (
    NODE_TYPE_LABEL,
    PROVIDER_ID_LABEL,
    GCEGPUProvider,
)

PKGS = {
    "jax": (jauto, jsched, jprovider),
    "port": (tauto, tsched, tprovider),
}


# ------------------------------------------------------ scheduler decisions
def _cfg(auto, **kw):
    defaults = dict(
        node_types={
            "cpu4": auto.NodeTypeConfig("cpu4", {"CPU": 4.0}, max_workers=5),
            "tpu8": auto.NodeTypeConfig(
                "tpu8", {"CPU": 8.0, "TPU": 8.0}, max_workers=2),
            "gpu8": auto.NodeTypeConfig(
                "gpu8", {"CPU": 16.0, "GPU": 8.0}, max_workers=2),
        },
        idle_timeout_s=60.0,
    )
    defaults.update(kw)
    return auto.AutoscalingConfig(**defaults)


def _state(nodes=None, pending_actors=(), pending_pgs=(), requested=(),
           queued=None):
    state = {
        "nodes": nodes or {},
        "pending_actors": list(pending_actors),
        "pending_pgs": list(pending_pgs),
        "requested_resources": list(requested),
    }
    if queued is not None:
        state["queued_task_demands"] = list(queued)
    return state


def _node(prov, pid="p0", avail=4.0, total=4.0, idle=0.0, alive=True,
          draining=None, labelled=True):
    node = {
        "alive": alive,
        "total": {"CPU": total},
        "available": {"CPU": avail},
        "labels": ({prov.NODE_TYPE_LABEL: "cpu4",
                    prov.PROVIDER_ID_LABEL: pid} if labelled else {}),
        "pending_demands": [],
        "idle_s": idle,
    }
    if draining is not None:
        node["draining"] = draining
    return node


def _min_cpu4(auto, n):
    return {"cpu4": auto.NodeTypeConfig("cpu4", {"CPU": 4.0}, min_workers=n,
                                        max_workers=5)}


# name -> (case(auto, prov) -> (state, cfg, provider_nodes), expected)
DECISIONS = {
    "launch_for_pending_actor": (
        lambda a, p: (_state(pending_actors=[{"CPU": 2.0}]), _cfg(a), {}),
        {"to_launch": {"cpu4": 1}, "infeasible": []}),
    "tpu_demand_picks_tpu_type": (
        lambda a, p: (_state(pending_actors=[{"CPU": 1.0, "TPU": 4.0}]),
                      _cfg(a), {}),
        {"to_launch": {"tpu8": 1}}),
    "gpu_demand_picks_gpu_type": (
        lambda a, p: (_state(pending_actors=[{"CPU": 1.0, "GPU": 4.0}]),
                      _cfg(a), {}),
        {"to_launch": {"gpu8": 1}}),
    "fractional_gpus_pack_on_one_gpu_node": (
        lambda a, p: (_state(pending_actors=[{"CPU": 1.0, "GPU": 0.5}] * 2),
                      _cfg(a), {}),
        {"to_launch": {"gpu8": 1}}),
    "packs_multiple_demands_on_one_node": (
        lambda a, p: (_state(pending_actors=[{"CPU": 2.0}, {"CPU": 2.0}]),
                      _cfg(a), {}),
        {"to_launch": {"cpu4": 1}}),
    "existing_capacity_absorbs_demand": (
        lambda a, p: (_state(nodes={"n1": _node(p, labelled=False)},
                             pending_actors=[{"CPU": 3.0}]), _cfg(a), {}),
        {"to_launch": {}}),
    "infeasible_demand": (
        lambda a, p: (_state(pending_actors=[{"GPU": 16.0}]), _cfg(a), {}),
        {"infeasible": [{"GPU": 16.0}], "to_launch": {}}),
    "max_workers_cap": (
        lambda a, p: (_state(pending_actors=[{"CPU": 4.0}] * 3), _cfg(a),
                      {f"p{i}": "cpu4" for i in range(5)}),
        {}),
    "min_workers_floor": (
        lambda a, p: (_state(), _cfg(a, node_types=_min_cpu4(a, 2)), {}),
        {"to_launch": {"cpu4": 2}}),
    "pg_bundles_counted": (
        lambda a, p: (_state(pending_pgs=[
            {"strategy": "PACK", "bundles": [{"CPU": 4.0}, {"CPU": 4.0}]}]),
            _cfg(a), {}),
        {"to_launch": {"cpu4": 2}}),
    "gpu_pg_bundles_spread": (
        lambda a, p: (_state(pending_pgs=[
            {"strategy": "SPREAD", "bundles": [{"CPU": 1.0, "GPU": 0.5}] * 2}]),
            _cfg(a), {}),
        {"to_launch": {"gpu8": 1}}),
    "strict_pack_pg_is_atomic": (
        lambda a, p: (_state(pending_pgs=[
            {"strategy": "STRICT_PACK",
             "bundles": [{"CPU": 4.0}, {"CPU": 4.0}]}]),
            _cfg(a), {}),
        {}),
    "strict_spread_needs_distinct_nodes": (
        lambda a, p: (_state(pending_pgs=[
            {"strategy": "STRICT_SPREAD",
             "bundles": [{"CPU": 1.0}, {"CPU": 1.0}]}]), _cfg(a), {}),
        {"to_launch": {"cpu4": 2}}),
    "requested_resources_check_totals_not_available": (
        lambda a, p: (_state(nodes={"n1": _node(p, avail=0.0,
                                                labelled=False)},
                             requested=[{"CPU": 4.0}]), _cfg(a), {}),
        {"to_launch": {}}),
    "scale_down_not_blocked_by_infeasible_demand": (
        lambda a, p: (_state(nodes={"n0": _node(p, idle=100.0)},
                             pending_actors=[{"GPU": 16.0}]),
                      _cfg(a, idle_timeout_s=10.0), {"p0": "cpu4"}),
        {"infeasible": [{"GPU": 16.0}], "to_terminate": ["p0"]}),
    "idle_terminate_respects_min_workers": (
        lambda a, p: (_state(nodes={f"n{i}": _node(p, pid=f"p{i}", idle=100.0)
                                    for i in range(3)}),
                      _cfg(a, node_types=_min_cpu4(a, 1), idle_timeout_s=10.0),
                      {f"p{i}": "cpu4" for i in range(3)}),
        {}),
    "no_terminate_while_busy": (
        lambda a, p: (_state(nodes={"n0": _node(p, idle=100.0)},
                             pending_actors=[{"CPU": 2.0}]),
                      _cfg(a, idle_timeout_s=10.0), {"p0": "cpu4"}),
        {"to_terminate": []}),
    "draining_node_excluded_from_packing": (
        lambda a, p: (_state(nodes={"n0": _node(p, draining=True)},
                             pending_actors=[{"CPU": 2.0}]),
                      _cfg(a), {"p0": "cpu4"}),
        {"to_launch": {"cpu4": 1}}),
    "draining_node_not_reselected_for_idle_terminate": (
        lambda a, p: (_state(nodes={"n0": _node(p, idle=100.0,
                                                draining=True)}),
                      _cfg(a, idle_timeout_s=10.0), {"p0": "cpu4"}),
        {"to_terminate": []}),
    "queued_task_demands_feed_packing": (
        lambda a, p: (_state(queued=[{"CPU": 2.0}, {"CPU": 2.0}]), _cfg(a),
                      {}),
        {"to_launch": {"cpu4": 1}, "pending_demand": 2}),
    "queued_gpu_task_launches_gpu_type": (
        lambda a, p: (_state(queued=[{"CPU": 1.0, "GPU": 1.0}]), _cfg(a), {}),
        {"to_launch": {"gpu8": 1}, "pending_resources": {"CPU": 1.0,
                                                         "GPU": 1.0}}),
    "pending_demand_summary": (
        lambda a, p: (_state(pending_actors=[{"CPU": 2.0}, {"CPU": 1.0}]),
                      _cfg(a), {}),
        {"pending_demand": 2, "pending_resources": {"CPU": 3.0}}),
    "provisioning_record_counts_as_capacity": (
        lambda a, p: (_state(pending_actors=[{"CPU": 2.0}]), _cfg(a),
                      {"p0": "cpu4"}),
        {"to_launch": {}}),
    "dead_registered_node_does_not_absorb_demand": (
        lambda a, p: (_state(nodes={"n0": _node(p, alive=False,
                                                draining=False)},
                             pending_actors=[{"CPU": 2.0}]),
                      _cfg(a), {"p0": "cpu4"}),
        {"to_launch": {"cpu4": 1}}),
    "strict_spread_exclusive_on_planned_nodes": (
        lambda a, p: (_state(pending_actors=[{"CPU": 1.0}], pending_pgs=[
            {"strategy": "STRICT_SPREAD",
             "bundles": [{"CPU": 1.0}, {"CPU": 1.0}]}]), _cfg(a), {}),
        {"to_launch": {"cpu4": 3}, "infeasible": []}),
    "max_launch_batch_trims": (
        lambda a, p: (_state(pending_actors=[{"CPU": 4.0}] * 5),
                      _cfg(a, max_launch_batch=2), {}),
        {}),
    "global_max_workers_clamp": (
        lambda a, p: (_state(pending_actors=[{"CPU": 4.0}] * 3),
                      _cfg(a, max_workers=1), {}),
        {}),
}


def _decide(pkg, name):
    auto, sched, prov = PKGS[pkg]
    state, cfg, provider_nodes = DECISIONS[name][0](auto, prov)
    return dataclasses.asdict(
        sched.compute_scaling_decision(state, cfg, provider_nodes))


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_decision_equals_jax(name):
    got, want = _decide("port", name), _decide("jax", name)
    assert got == want
    for key, value in DECISIONS[name][1].items():
        assert got[key] == value, (key, got)
    if name == "max_workers_cap":
        assert got["to_launch"].get("cpu4", 0) == 0
    if name == "strict_pack_pg_is_atomic":
        # Two 4-CPU bundles on one node: a type with 8 CPUs or more.
        assert sum(got["to_launch"].values()) == 1
        assert "cpu4" not in got["to_launch"]
    if name == "idle_terminate_respects_min_workers":
        assert len(got["to_terminate"]) == 2
    if name == "max_launch_batch_trims":
        assert sum(got["to_launch"].values()) == 2
    if name == "global_max_workers_clamp":
        assert sum(got["to_launch"].values()) == 1
        assert len(got["infeasible"]) == 2


# ------------------------------------------------------------ launch backoff
@pytest.mark.parametrize("elastic", [jelastic, telastic], ids=["jax", "port"])
def test_backoff_gate_closes_on_failure_and_resets_on_success(elastic):
    b = elastic.LaunchBackoff(base_s=1.0, cap_s=30.0)
    assert b.ready(now=0.0)
    delay = b.record_failure(now=0.0)
    assert 1.0 <= delay <= 30.0
    assert b.consecutive_failures == 1
    assert not b.ready(now=0.0)
    assert b.remaining_s(now=0.0) == pytest.approx(delay)
    assert b.ready(now=delay + 0.001)
    b.record_success()
    assert b.consecutive_failures == 0
    assert b.ready(now=0.0)
    assert b.remaining_s(now=0.0) == 0.0


def test_backoff_delays_jittered_and_capped():
    b = telastic.LaunchBackoff(base_s=0.5, cap_s=4.0)
    delays = [b.record_failure(now=float(i)) for i in range(20)]
    assert all(0.5 <= d <= 4.0 for d in delays)
    assert b.consecutive_failures == 20
    assert len({round(d, 6) for d in delays}) > 1


# --------------------------------------------------------------- node drainer
class _StubCp:
    """Scripted drain_status replies; records every control-plane call."""

    def __init__(self, statuses=()):
        self.statuses = list(statuses)
        self.log = []

    def __call__(self, method, payload=None, timeout=30.0):
        self.log.append((method, dict(payload or {})))
        if method == "drain_status":
            if self.statuses:
                return self.statuses.pop(0)
            return {"known": True, "alive": True, "draining": True,
                    "drained": False}
        return {"ok": True}

    def calls(self, method):
        return [p for m, p in self.log if m == method]


class _StubProvider:
    def __init__(self, fail_next=0):
        self.fail_next = fail_next
        self.create_calls = 0
        self.terminated = []
        self._nodes = {}

    def create_node(self, node_type):
        self.create_calls += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("stockout")
        pid = f"stub-{self.create_calls}"
        self._nodes[pid] = node_type.name
        return pid

    def terminate_node(self, pid):
        self.terminated.append(pid)
        self._nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return dict(self._nodes)


DRAINED = {"known": True, "alive": True, "draining": True, "drained": True}
LOST_MARK = {"known": True, "alive": True, "draining": False,
             "drained": False}


def _drainer(cp, timeout_s=60.0):
    return telastic.NodeDrainer(cp, _StubProvider(), timeout_s=timeout_s)


def test_drained_node_terminated_and_retired():
    cp = _StubCp(statuses=[DRAINED])
    d = _drainer(cp)
    d.request("p1", "aa" * 16, cause="test")
    assert d.is_draining("p1")
    assert len(cp.calls("drain_node")) == 1
    assert d.poll() == ["p1"]
    assert not d.is_draining("p1")
    assert d.stats["drained"] == 1
    assert d._provider.terminated == ["p1"]
    assert len(cp.calls("drain_complete")) == 1


def test_lost_mark_reissued_after_failover():
    cp = _StubCp(statuses=[LOST_MARK])
    d = _drainer(cp)
    d.request("p1", "bb" * 16, cause="test")
    d.poll()
    assert len(cp.calls("drain_node")) == 2
    assert d.is_draining("p1")


def test_drain_timeout_terminates_anyway():
    cp = _StubCp()
    d = _drainer(cp, timeout_s=0.0)
    d.request("p1", "cc" * 16, cause="test")
    assert d.poll() == ["p1"]
    assert d.stats["timeout"] == 1
    assert d._provider.terminated == ["p1"]


def test_unregistered_node_skips_mark():
    cp = _StubCp()
    d = _drainer(cp, timeout_s=0.0)
    d.request("p1", None, cause="never registered")
    assert cp.calls("drain_node") == []
    assert d.poll() == ["p1"]
    assert cp.calls("drain_complete") == []
    assert d.stats["timeout"] == 1


def test_cancel_reopens_node():
    cp = _StubCp()
    d = _drainer(cp)
    d.request("p1", "dd" * 16, cause="test")
    d.cancel("p1")
    assert not d.is_draining("p1")
    assert d.stats["cancelled"] == 1
    assert len([p for p in cp.calls("drain_node") if p.get("cancel")]) == 1
    assert d._provider.terminated == []


def test_failures_gate_launches_then_recover(monkeypatch):
    """The reconcile loop against a failing provider, with no cluster: load
    state and status publishing stubbed, the launch path real."""
    provider = _StubProvider(fail_next=2)
    scaler = Autoscaler(
        AutoscalingConfig(
            node_types={"gpu1": NodeTypeConfig("gpu1", {"CPU": 2.0,
                                                        "GPU": 1.0},
                                               max_workers=2)},
            launch_backoff_base_s=0.2, launch_backoff_cap_s=0.4),
        provider, "stub:0")
    monkeypatch.setattr(
        scaler, "_get_load_state",
        lambda: _state(pending_actors=[{"CPU": 1.0, "GPU": 1.0}]))
    monkeypatch.setattr(scaler, "_publish_status", lambda d: None)

    d1 = scaler.update()
    assert provider.create_calls == 1
    assert d1.launch_failures == {"gpu1": 1}
    assert d1.backoff_remaining_s.get("gpu1", 0.0) > 0.0
    for _ in range(5):
        scaler.update()
    assert provider.create_calls == 1
    time.sleep(0.45)
    d3 = scaler.update()
    assert provider.create_calls == 2
    assert d3.launch_failures == {"gpu1": 2}
    time.sleep(0.45)
    d4 = scaler.update()
    assert provider.create_calls == 3
    assert d4.launch_failures == {}
    assert d4.backoff_remaining_s == {}
    scaler.update()
    assert provider.create_calls == 3


# ------------------------------------------------------------ port clusters
def _scale_down(scaler, provider, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        time.sleep(1.0)
        scaler.update()
    assert provider.non_terminated_nodes() == {}


def test_scale_up_schedules_pending_actor_then_scales_down():
    ctx = ray_tpu_torch.init(num_cpus=1)
    provider = None
    try:
        cp = ctx.address_info["cp_address"]
        provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
        scaler = Autoscaler(AutoscalingConfig(
            node_types={"worker4": NodeTypeConfig("worker4", {"CPU": 4.0},
                                                  max_workers=2)},
            idle_timeout_s=3.0), provider, cp)

        @ray_tpu_torch.remote(num_cpus=4)
        class Big:
            def ping(self):
                return "pong"

        handle = Big.remote()  # cannot fit on the 1-CPU head
        time.sleep(1.0)
        assert scaler.update().to_launch == {"worker4": 1}
        assert ray_tpu_torch.get(handle.ping.remote(), timeout=60) == "pong"
        ray_tpu_torch.kill(handle)
        _scale_down(scaler, provider)
    finally:
        if provider is not None:
            provider.shutdown()
        ray_tpu_torch.shutdown()


def test_request_resources_and_stop_pattern_matches_a_worker():
    ctx = ray_tpu_torch.init(num_cpus=1)
    provider = None
    try:
        cp = ctx.address_info["cp_address"]
        provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
        scaler = Autoscaler(AutoscalingConfig(
            node_types={"worker4": NodeTypeConfig("worker4", {"CPU": 4.0},
                                                  max_workers=2)}),
            provider, cp)
        request_resources(bundles=[{"CPU": 4.0}])
        assert scaler.update().to_launch == {"worker4": 1}
        from ray_tpu_torch.autoscaler.autoscaler import wait_for_nodes

        wait_for_nodes(2, cp, timeout=30)
        time.sleep(1.5)  # heartbeat refresh
        assert scaler.update().to_launch == {}
        request_resources()  # clear

        @ray_tpu_torch.remote
        def cmdline():
            with open("/proc/self/cmdline", "rb") as f:
                return f.read().replace(b"\0", b" ").decode()

        worker = ray_tpu_torch.get(cmdline.remote(), timeout=60)
    finally:
        if provider is not None:
            provider.shutdown()
        ray_tpu_torch.shutdown()
    pattern = _stop_pattern()
    assert "ray_tpu_torch.core" in worker
    assert re.search(pattern, worker), (pattern, worker)
    # The JAX package's pattern never matches a port process.
    assert not re.search(r"[r]ay_tpu[.]core", worker)


def _stop_pattern():
    default = inspect.signature(ManagedVMProvider.__init__).parameters[
        "stop_command"].default
    return re.fullmatch(r"pkill -f '([^']+)' \|\| true", default).group(1)


def test_stop_pattern_spares_its_own_shell():
    """``pgrep`` (never ``pkill``) with the default stop pattern, from a
    shell whose command line holds the pattern, next to a process whose
    command line names a port module: the process is found, the shell
    is not."""
    pattern = _stop_pattern()
    sleeper = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)",
         "ray_tpu_torch.core.worker_main"])
    try:
        shell = subprocess.run(
            ["sh", "-c", f"echo $$; pgrep -f '{pattern}' || true"],
            capture_output=True, text=True, timeout=30)
        lines = shell.stdout.split()
        shell_pid, found = lines[0], set(lines[1:])
        assert str(sleeper.pid) in found
        assert shell_pid not in found
    finally:
        sleeper.kill()
        sleeper.wait(timeout=30)


def test_gpu_task_launches_gpu_node_then_scales_down():
    """A head with no card, a GPU node type (min 0, max 1), and a
    ``num_gpus=1`` task with nothing to run it on: the autoscaler launches
    the node, the task runs under its card's lease, and the cluster's GPU
    total is 1 while the node is up and 0 after scale-down."""
    ctx = ray_tpu_torch.init(num_cpus=1)
    provider = None
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) == 0.0
        cp = ctx.address_info["cp_address"]
        provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
        scaler = Autoscaler(AutoscalingConfig(
            node_types={"gpu1": NodeTypeConfig("gpu1", {"CPU": 2.0,
                                                        "GPU": 1.0},
                                               min_workers=0, max_workers=1)},
            idle_timeout_s=2.0), provider, cp)

        @ray_tpu_torch.remote(num_gpus=1)
        def leased():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        ref = leased.remote()
        deadline = time.monotonic() + 30
        launched = {}
        while not launched and time.monotonic() < deadline:
            time.sleep(0.5)
            launched = scaler.update().to_launch
        assert launched == {"gpu1": 1}
        assert ray_tpu_torch.get(ref, timeout=60) == "0"
        assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0
        _scale_down(scaler, provider)
        deadline = time.monotonic() + 30
        while (ray_tpu_torch.cluster_resources().get("GPU", 0.0) != 0.0
               and time.monotonic() < deadline):
            time.sleep(0.5)
        assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) == 0.0
    finally:
        if provider is not None:
            provider.shutdown()
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------- port divergences
def test_fake_node_registers_a_card_only_where_its_type_names_gpu(
        monkeypatch):
    """On a card's host the port's Node merges the detected card under
    the node type's resources: a fake node of a CPU type must not register
    it again, and a GPU type registers exactly what it names."""
    from ray_tpu_torch.core import gpu_detect

    ctx = ray_tpu_torch.init(num_cpus=1)
    provider = None
    try:
        monkeypatch.setattr(gpu_detect, "models",
                            lambda *a, **k: ["NVIDIA H100 80GB HBM3"])
        cp = ctx.address_info["cp_address"]
        provider = FakeMultiNodeProvider(cp, ctx.address_info["session_id"])
        cpu = provider.create_node(NodeTypeConfig("cpu1", {"CPU": 1.0}))
        gpu = provider.create_node(NodeTypeConfig("gpu1", {"CPU": 1.0,
                                                           "GPU": 1.0}))
        nodes = provider._nodes
        assert nodes[cpu][1].resources["GPU"] == 0.0
        assert nodes[gpu][1].resources["GPU"] == 1.0
        from ray_tpu_torch.autoscaler.autoscaler import wait_for_nodes

        wait_for_nodes(3, cp, timeout=30)
        assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0
    finally:
        if provider is not None:
            provider.shutdown()
        ray_tpu_torch.shutdown()


def test_gce_gpu_provider_command_lines(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    calls = []
    prov = GCEGPUProvider("proj", "us-central1-a", "c1", "10.0.0.2:6380")
    monkeypatch.setattr(prov, "_run", lambda *args: calls.append(args) or "")
    node_type = NodeTypeConfig(
        "gpu1", {"CPU": 26.0, "GPU": 1.0},
        node_config={"machine_type": "a3-highgpu-1g",
                     "accelerator_type": "nvidia-h100-80gb",
                     "accelerator_count": 1})
    pid = prov.create_node(node_type)
    assert re.fullmatch(r"c1-gpu1-[0-9a-f]{6}", pid)
    (create,) = calls
    assert create[:4] == ("compute", "instances", "create", pid)
    assert "--machine-type=a3-highgpu-1g" in create
    assert "--accelerator=type=nvidia-h100-80gb,count=1" in create
    assert "--maintenance-policy=TERMINATE" in create
    (startup,) = [a for a in create if a.startswith("--metadata=")]
    assert startup.startswith(
        "--metadata=startup-script=python -m ray_tpu_torch start "
        "--address=10.0.0.2:6380 --labels ")
    assert f'"{PROVIDER_ID_LABEL}": "{pid}"' in startup
    assert f'"{NODE_TYPE_LABEL}": "gpu1"' in startup
    assert prov.non_terminated_nodes() == {pid: "gpu1"}
    # Defaults fill what node_config leaves out.
    prov.create_node(NodeTypeConfig("gpu8", {"GPU": 8.0},
                                    node_config={"accelerator_count": 8}))
    assert "--accelerator=type=nvidia-h100-80gb,count=8" in calls[1]
    prov.terminate_node(pid)
    assert calls[2] == ("compute", "instances", "delete", pid, "--quiet")
    prov.terminate_node(pid)  # idempotent
    assert len(calls) == 3
    assert pid not in prov.non_terminated_nodes()


def test_gce_gpu_provider_runs_gcloud_with_project_and_zone(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    seen = []
    monkeypatch.setattr(subprocess, "check_output",
                        lambda argv, text: seen.append(argv) or "[]")
    prov = GCEGPUProvider("proj", "zone-a", "c1", "h:1")
    assert prov._run("compute", "instances", "list") == "[]"
    assert seen == [["gcloud", "compute", "instances", "list",
                     "--project=proj", "--zone=zone-a", "--format=json"]]
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="gcloud"):
        GCEGPUProvider("proj", "zone-a", "c1", "h:1")
