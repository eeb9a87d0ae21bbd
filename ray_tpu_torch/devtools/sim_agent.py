"""Simulated node agent: the control-plane-facing half of a node,
without workers.

``bench.py limits`` needs the control plane's *scale envelope* — how
many node agents it can carry through a leader failover — but spawning
64+ REAL agents (each with worker pools, shm arenas, object
directories) would exhaust a laptop long before the control plane is
the bottleneck.  A ``SimNodeAgent`` speaks the full agent wire
protocol (register/heartbeat/re-register with ``held_pgs``, the bundle
two-phase-commit batch RPCs, actor-worker creation) against the real
control plane, but execution is fake: "workers" are synthetic
addresses that are never connected to, and resource accounting is a
plain dict.  The chaos boundary is the node's execution half —
everything CP-side (scheduling, journaling, lease failover, client
re-anchor through ``make_cp_resolver``) is production code.

Run as a subprocess fleet (``python -m ray_tpu_torch.devtools.sim_agent``);
each process dies with its parent via the reaper watchdog, so a killed
bench cannot leak a 64-process fleet.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
from typing import Dict, Optional

from ..core.config import GlobalConfig
from ..core.cp_ha import make_cp_resolver
from ..core.ids import NodeID
from ..core.rpc import RetryableRpcClient, RpcServer

logger = logging.getLogger(__name__)


class SimNodeAgent:
    """Agent-protocol endpoint with dict-based resource accounting and
    no worker processes.  Unknown CP→agent RPCs are acked benignly (a
    sim node has nothing to remediate, prestart, or evict)."""

    def __init__(self, host: str, port: int, cp_address: str,
                 session_id: str, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 cp_ha_dir: Optional[str] = None):
        self.node_id = NodeID.from_random()
        self.session_id = session_id
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels or {})
        self.cp_ha_dir = cp_ha_dir
        resolver = (
            make_cp_resolver(cp_ha_dir, cp_address) if cp_ha_dir else None
        )
        self.cp_client = RetryableRpcClient(
            cp_address, address_resolver=resolver
        )
        self.server = RpcServer(self, host, port)
        # pg_id -> summed reservation (the real agent tracks per-bundle
        # pools; the CP only ever observes the aggregate + held_pgs).
        self.bundles: Dict[object, Dict[str, float]] = {}
        self.workers: Dict[str, Dict[str, float]] = {}
        self._worker_seq = 0
        self.registrations = 0   # register_node round-trips (incl. re-reg)
        self._hb_task: Optional[asyncio.Task] = None

    # ---------------------------------------------------------- lifecycle
    async def start(self) -> str:
        addr = await self.server.start()
        await self._register(addr)
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop()
        )
        logger.info("sim agent %s on %s", self.node_id.hex()[:8], addr)
        return addr

    async def stop(self):
        if self._hb_task is not None:
            self._hb_task.cancel()
        await self.server.stop()
        await self.cp_client.close()

    async def _register(self, addr: str):
        reply = await self.cp_client.call(
            "register_node",
            {
                "node_id": self.node_id,
                "agent_address": addr,
                "snapshot": self._snapshot(),
                "held_pgs": list(self.bundles),
            },
        )
        assert reply["ok"]
        # Reconciliation: groups the CP removed/evicted while this node
        # (or the CP itself) was away must release their reservations.
        for pg_id in reply.get("drop_pgs") or ():
            self._drop_pg(pg_id)
        self.registrations += 1

    def _snapshot(self) -> dict:
        return {
            "total": dict(self.total),
            "available": dict(self.available),
            "labels": dict(self.labels),
            "pending_demands": [],
            "idle_s": 0.0,
        }

    async def _heartbeat_loop(self):
        period = GlobalConfig.health_check_period_s
        while True:
            try:
                reply = await self.cp_client.call(
                    "heartbeat",
                    {"node_id": self.node_id, "snapshot": self._snapshot()},
                    retries=1,
                )
                if reply.get("reregister"):
                    # A fresh leader (or restarted CP) lost the volatile
                    # node table: replay registration with held_pgs so it
                    # can reconcile reservations against its journal.
                    await self._register(self.server.address)
            except Exception as e:  # noqa: BLE001 — leaderless windows are expected
                logger.debug("sim heartbeat failed: %s", e)
            await asyncio.sleep(period)

    # -------------------------------------------------- resource accounting
    def _reserve(self, need: Dict[str, float]) -> bool:
        for k, v in need.items():
            if self.available.get(k, 0.0) + 1e-9 < v:
                return False
        for k, v in need.items():
            self.available[k] = self.available.get(k, 0.0) - v
        return True

    def _release(self, held: Dict[str, float]):
        for k, v in held.items():
            self.available[k] = min(
                self.total.get(k, 0.0), self.available.get(k, 0.0) + v
            )

    def _prepare_pg(self, pg_id, bundles: Dict[int, Dict[str, float]]) -> bool:
        # ``bundles`` is the agent wire shape: {bundle_index: resource spec}.
        need: Dict[str, float] = {}
        for b in bundles.values():
            for k, v in b.items():
                need[k] = need.get(k, 0.0) + v
        if not self._reserve(need):
            return False
        prev = self.bundles.get(pg_id)
        if prev is not None:
            self._release(prev)
        self.bundles[pg_id] = need
        return True

    def _drop_pg(self, pg_id):
        held = self.bundles.pop(pg_id, None)
        if held:
            self._release(held)

    # ----------------------------------------------------- agent protocol
    def handle_ping(self, payload, conn):
        return "pong"

    def handle_prepare_bundles_batch(self, payload, conn):
        return {
            "results": {
                g["pg_id"]: self._prepare_pg(g["pg_id"], g["bundles"])
                for g in payload["groups"]
            }
        }

    handle_reserve_bundles_batch = handle_prepare_bundles_batch

    def handle_prepare_bundles(self, payload, conn):
        return {"ok": self._prepare_pg(payload["pg_id"], payload["bundles"])}

    def handle_commit_bundles(self, payload, conn):
        return True

    def handle_commit_bundles_batch(self, payload, conn):
        return True

    def handle_cancel_bundles(self, payload, conn):
        self._drop_pg(payload["pg_id"])
        return True

    def handle_cancel_bundles_batch(self, payload, conn):
        for pg_id in payload["pg_ids"]:
            self._drop_pg(pg_id)
        return True

    handle_return_bundles = handle_cancel_bundles
    handle_return_bundles_batch = handle_cancel_bundles_batch

    async def handle_create_actor_worker(self, payload, conn):
        spec = payload["spec"]
        need = dict(spec.resources)
        if spec.placement_group_id is None and not self._reserve(need):
            raise ValueError("insufficient resources for actor")
        self._worker_seq += 1
        addr = f"sim-{self.node_id.hex()[:8]}:{self._worker_seq}"
        self.workers[addr] = (
            need if spec.placement_group_id is None else {}
        )
        return {"worker_address": addr}

    async def handle_kill_worker(self, payload, conn):
        held = self.workers.pop(payload.get("worker_address"), None)
        if held:
            self._release(held)
        return True

    async def handle_prepare_evict(self, payload, conn):
        return {"acks": 0, "workers": 0}

    def handle_list_objects(self, payload, conn):
        return []

    def handle_free_objects(self, payload, conn):
        return True

    def handle_prestart_pool(self, payload, conn):
        return True

    async def handle_remediate(self, payload, conn):
        return {"ok": True, "results": []}

    def handle_debug_state(self, payload, conn):
        return {
            "node_id": self.node_id.hex(),
            "registrations": self.registrations,
            "held_pgs": len(self.bundles),
            "workers": len(self.workers),
            "available": dict(self.available),
        }

    def on_connection_closed(self, conn):
        return None


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--cp-address", required=True)
    parser.add_argument("--session-id", required=True)
    parser.add_argument("--resources", required=True, help="JSON dict")
    parser.add_argument("--labels", default="{}", help="JSON dict")
    parser.add_argument("--cp-ha-dir", default=None)
    parser.add_argument("--ready-file", default=None,
                        help="written with the bound address once registered")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    from ..core.reaper import watch_parent_process

    watch_parent_process()

    async def run():
        agent = SimNodeAgent(
            args.host,
            args.port,
            args.cp_address,
            args.session_id,
            json.loads(args.resources),
            json.loads(args.labels),
            cp_ha_dir=args.cp_ha_dir,
        )
        addr = await agent.start()
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(addr)
            os.replace(tmp, args.ready_file)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(run())


if __name__ == "__main__":
    main()
