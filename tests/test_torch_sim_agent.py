"""The simulated node agent (``ray_tpu_torch.devtools.sim_agent``) through a
control-plane failover: four ``python -m ray_tpu_torch.devtools.sim_agent``
processes register with an HA head, ``chaos.KilledLeader`` kills the
leader, and every agent registers again with the new leader (the fleet
``bench.py limits`` runs at 64 agents, here at 4)."""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.core.rpc import RetryableRpcClient
from ray_tpu_torch.devtools.chaos import KilledLeader

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_AGENTS = 4


def _wait_for(pred, timeout, msg, period=0.25):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {msg}")


def test_sim_agents_register_again_with_the_new_leader(tmp_path):
    ray_tpu_torch.init(
        num_cpus=1,
        _system_config={"cp_ha": 1, "cp_lease_ttl_s": 1.0,
                        "cp_lease_poll_s": 0.1, "prestart_workers": 0},
    )
    procs = []
    try:
        node = api._local_node
        worker = api.global_worker()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        ready = [tmp_path / f"agent{i}.addr" for i in range(N_AGENTS)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.devtools.sim_agent",
                 "--cp-address", node.cp_address,
                 "--session-id", node.session_id,
                 "--cp-ha-dir", node.ha_dir,
                 "--resources", json.dumps({"SIM": 4.0}),
                 "--ready-file", str(path)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                env=env)
            for path in ready
        ]
        _wait_for(lambda: all(p.exists() for p in ready), 60,
                  "the agents' ready files")
        agents = [RetryableRpcClient(p.read_text()) for p in ready]

        def debug_states():
            return [worker._run_sync(a.call("debug_state", {}), timeout=30)
                    for a in agents]

        def alive_nodes():
            try:
                state = worker._run_sync(worker.cp.call("get_state"),
                                         timeout=30)
            except Exception:  # noqa: BLE001 — re-anchor in flight
                return set()
            return {nid for nid, n in state["nodes"].items() if n["alive"]}

        before = debug_states()
        sims = {s["node_id"] for s in before}
        assert len(sims) == N_AGENTS
        assert all(s["registrations"] == 1 for s in before), before
        _wait_for(lambda: sims <= alive_nodes(), 30, "the fleet alive")

        chaos = KilledLeader(node)
        with chaos:
            node.wait_for_failover(chaos.old_epoch, timeout=60)
            # Each agent's heartbeat to the new leader is answered with
            # "reregister" (the node table is volatile), and the agent
            # registers again; the new leader then holds the whole fleet.
            _wait_for(lambda: all(s["registrations"] >= 2
                                  for s in debug_states()),
                      60, "every agent registered again")
            _wait_for(lambda: sims <= alive_nodes(), 60,
                      "the fleet alive under the new leader")
        after = debug_states()
        assert {s["node_id"] for s in after} == sims
        assert all(s["registrations"] >= 2 for s in after), after
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
        ray_tpu_torch.shutdown()
