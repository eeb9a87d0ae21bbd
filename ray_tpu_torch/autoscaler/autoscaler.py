"""The autoscaler reconciler loop.

Reference: ray ``python/ray/autoscaler/v2/autoscaler.py:50`` +
``monitor.py`` — each round: poll the control plane's load state, compute a
scaling decision, drive the provider.  Runs in any process that can reach
the control plane (typically the head node, via ``Autoscaler.run``).

Lifecycle transitions route through ``elastic.py``: launches gate on a
per-type jittered backoff after provider failures, and terminations go
through the drain state machine (mark unschedulable -> evict residents
via prepare_evict -> terminate) instead of killing nodes under load.
Control-plane RPCs ride ONE persistent ``RetryableRpcClient`` with the
HA leader resolver attached, so the loop survives a failover window
instead of erroring through it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from typing import Dict, Optional

from .config import AutoscalingConfig
from .elastic import LaunchBackoff, NodeDrainer, build_status
from .provider import NodeProvider, PROVIDER_ID_LABEL
from .scheduler import ScalingDecision, compute_scaling_decision

logger = logging.getLogger(__name__)


class Autoscaler:
    def __init__(
        self,
        config: AutoscalingConfig,
        provider: NodeProvider,
        cp_address: str,
        cp_ha_dir: Optional[str] = None,
    ):
        self.config = config
        self.provider = provider
        self.cp_address = cp_address
        self._cp_ha_dir = cp_ha_dir or os.environ.get("RAY_TPU_TORCH_CP_HA_DIR")
        self._stop = threading.Event()
        self.last_decision: Optional[ScalingDecision] = None
        self._backoffs: Dict[str, LaunchBackoff] = {}
        self.drainer = NodeDrainer(
            self._call, provider, timeout_s=config.drain_timeout_s
        )
        # provider_id -> monotonic first-seen: the reclaim grace clock for
        # nodes the control plane never (or no longer) reports alive.
        self._first_seen: Dict[str, float] = {}
        # Dedicated event-loop thread owning the persistent RPC client
        # (RetryableRpcClient is async; the reconcile loop is a plain
        # thread).  Created lazily on first use.
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._rpc = None

    # -------------------------------------------------------------- rpc plane
    def _ensure_rpc(self):
        if self._rpc is not None:
            return
        from ..core.cp_ha import make_cp_resolver
        from ..core.rpc import RetryableRpcClient

        resolver = (
            make_cp_resolver(self._cp_ha_dir, self.cp_address)
            if self._cp_ha_dir
            else None
        )
        self._rpc = RetryableRpcClient(
            self.cp_address, address_resolver=resolver
        )
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="rtpu-autoscaler-rpc",
        )
        self._loop_thread.start()

    def _call(self, method: str, payload: Optional[dict] = None,
              timeout: float = 30.0):
        """One synchronous control-plane RPC.  Prefers a connected global
        worker's client (same process as the driver); otherwise the
        autoscaler's own persistent retryable client — NEVER a throwaway
        connection per round."""
        from ..core.core_worker import try_global_worker

        worker = try_global_worker()
        if worker is not None and worker.cp_address == self.cp_address:
            return worker._run_sync(worker.cp.call(method, payload))
        self._ensure_rpc()
        fut = asyncio.run_coroutine_threadsafe(
            self._rpc.call(method, payload), self._loop
        )
        return fut.result(timeout)

    def _get_load_state(self) -> dict:
        return self._call("get_load_state")

    def _backoff_for(self, tname: str) -> LaunchBackoff:
        b = self._backoffs.get(tname)
        if b is None:
            b = LaunchBackoff(
                base_s=self.config.launch_backoff_base_s,
                cap_s=self.config.launch_backoff_cap_s,
            )
            self._backoffs[tname] = b
        return b

    # ------------------------------------------------------------- one round
    def update(self) -> ScalingDecision:
        """One reconcile round; returns the decision it acted on."""
        from ..util import flight_recorder

        state = self._get_load_state()
        provider_nodes = self.provider.non_terminated_nodes()
        decision = compute_scaling_decision(
            state, self.config, provider_nodes
        )
        flight_recorder.record_autoscaler_pending_demand(
            decision.pending_demand
        )

        # ---- launches, gated by the per-type backoff
        now = time.monotonic()
        for tname, count in decision.to_launch.items():
            node_type = self.config.node_types[tname]
            backoff = self._backoff_for(tname)
            for _ in range(count):
                if not backoff.ready(now):
                    flight_recorder.record_autoscaler_launch(
                        tname, "backoff"
                    )
                    continue
                try:
                    pid = self.provider.create_node(node_type)
                    self._first_seen[pid] = time.monotonic()
                    backoff.record_success()
                    flight_recorder.record_autoscaler_launch(tname, "ok")
                    logger.info("launched %s (%s)", pid, tname)
                except Exception as e:  # noqa: BLE001 — provider flake; backoff gates the retry
                    delay = backoff.record_failure()
                    flight_recorder.record_autoscaler_launch(tname, "error")
                    logger.warning(
                        "launch of %s failed (%d consecutive, next attempt "
                        "in %.1fs): %s",
                        tname, backoff.consecutive_failures, delay, e,
                    )
                    break  # same type would fail again this round

        # ---- terminations: drain first (the state machine owns retirement)
        pid_to_node = {
            node.get("labels", {}).get(PROVIDER_ID_LABEL): nid_hex
            for nid_hex, node in state["nodes"].items()
        }
        for pid in decision.to_terminate:
            if self.drainer.is_draining(pid):
                continue
            if self.config.drain_before_terminate:
                self.drainer.request(
                    pid, pid_to_node.get(pid), cause="idle timeout"
                )
            else:
                try:
                    self.provider.terminate_node(pid)
                    flight_recorder.record_autoscaler_termination("direct")
                    logger.info("terminated %s", pid)
                except Exception as e:  # noqa: BLE001
                    flight_recorder.record_autoscaler_termination("error")
                    logger.warning("terminate of %s failed: %s", pid, e)
        self.drainer.poll()

        # ---- reclaim: provider records with no live control-plane node
        # past the grace window (crashed VM, failed provisioning) — churn
        # convergence, and the counter-half of double-launch protection.
        alive_pids = {
            node.get("labels", {}).get(PROVIDER_ID_LABEL)
            for node in state["nodes"].values()
            if node.get("alive")
        }
        for pid in list(provider_nodes):
            if pid in alive_pids or self.drainer.is_draining(pid):
                self._first_seen.setdefault(pid, now)
                continue
            first = self._first_seen.setdefault(pid, now)
            if now - first >= self.config.reclaim_grace_s:
                try:
                    self.provider.terminate_node(pid)
                    flight_recorder.record_autoscaler_termination(
                        "reclaimed"
                    )
                    logger.warning(
                        "reclaimed %s: no live node after %.0fs",
                        pid, now - first,
                    )
                except Exception as e:  # noqa: BLE001
                    logger.warning("reclaim of %s failed: %s", pid, e)
                self._first_seen.pop(pid, None)
        # A node the control plane reports alive restarts its grace clock
        # if it later disappears (e.g. killed by chaos).
        for pid in list(self._first_seen):
            if pid in alive_pids:
                self._first_seen[pid] = now

        if decision.infeasible:
            logger.warning(
                "infeasible resource demands (no node type fits): %s",
                decision.infeasible[:5],
            )

        # ---- surface backoff + drain state in the decision and the panel
        for tname, b in self._backoffs.items():
            if b.consecutive_failures:
                decision.launch_failures[tname] = b.consecutive_failures
            rem = b.remaining_s(time.monotonic())
            if rem > 0:
                decision.backoff_remaining_s[tname] = round(rem, 3)
        decision.draining = [
            d["provider_id"] for d in self.drainer.active()
        ]
        self.last_decision = decision
        self._publish_status(decision)
        return decision

    def _publish_status(self, decision: ScalingDecision) -> None:
        per_type: Dict[str, int] = {}
        for tname in self.provider.non_terminated_nodes().values():
            per_type[tname] = per_type.get(tname, 0) + 1
        for tname in self.config.node_types:
            self._backoff_for(tname)
        status = build_status(
            decision, per_type, self._backoffs, self.drainer,
            provider_nodes=sum(per_type.values()),
        )
        status["ts"] = time.time()
        try:
            self._call(
                "kv_put",
                {"namespace": "autoscaler", "key": "status",
                 "value": status},
            )
        except Exception as e:  # noqa: BLE001 — panel is best-effort telemetry
            logger.debug("autoscaler status publish failed: %s", e)

    # ------------------------------------------------------------------ loop
    def run(self, period_s: float = 5.0) -> None:
        """Blocking reconcile loop (``ray_tpu_torch.autoscaler.monitor`` analog)."""
        while not self._stop.is_set():
            try:
                self.update()
            except Exception as e:  # noqa: BLE001
                logger.warning("autoscaler round failed: %s", e)
            self._stop.wait(period_s)

    def start_background(self, period_s: float = 5.0) -> threading.Thread:
        thread = threading.Thread(
            target=self.run, args=(period_s,), daemon=True,
            name="rtpu-autoscaler",
        )
        self._thread = thread
        thread.start()
        return thread

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Signal the reconcile loop and join a background thread if one
        was started, so teardown observes the last round completing
        instead of abandoning it mid-provider-call."""
        self._stop.set()
        thread = getattr(self, "_thread", None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=join_timeout_s)
        if self._loop is not None:
            if self._rpc is not None:
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._rpc.close(), self._loop
                    ).result(timeout=5.0)
                except Exception as e:  # noqa: BLE001 — teardown best-effort
                    logger.debug("autoscaler rpc close failed: %s", e)
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=5.0)


def wait_for_nodes(n: int, cp_address: str, timeout: float = 60.0) -> None:
    """Test/ops helper: block until n nodes are alive."""
    from ..util.state.api import StateApiClient

    client = StateApiClient(cp_address)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        nodes = client.get_state()["nodes"]
        if sum(1 for v in nodes.values() if v["alive"]) >= n:
            return
        time.sleep(0.3)
    raise TimeoutError(f"cluster did not reach {n} nodes in {timeout}s")
