"""Node providers: how the autoscaler launches and terminates machines.

Reference: ray ``python/ray/autoscaler/node_provider.py`` (v1 ABC) and the
``FakeMultiNodeProvider`` testing trick
(``autoscaler/_private/fake_multi_node/node_provider.py:237``): fake nodes
are real node-agent processes on this machine, each believing it is a
distinct node — so autoscaler end-to-end tests run without a cloud.

Every launched node carries two labels the autoscaler uses to reconcile
provider state against the control plane's node table:
``rtpu-node-type`` and ``rtpu-provider-id``.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

from .config import NodeTypeConfig

NODE_TYPE_LABEL = "rtpu-node-type"
PROVIDER_ID_LABEL = "rtpu-provider-id"


class NodeProvider:
    """ABC.  Implementations must be idempotent and tolerate repeated
    terminate calls."""

    def create_node(self, node_type: NodeTypeConfig) -> str:
        """Launch one node of the given type; returns a provider id."""
        raise NotImplementedError

    def terminate_node(self, provider_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> Dict[str, str]:
        """provider_id -> node_type name."""
        raise NotImplementedError

    def shutdown(self) -> None:
        for pid in list(self.non_terminated_nodes()):
            self.terminate_node(pid)


class FakeMultiNodeProvider(NodeProvider):
    """Launches real local node-agent processes joined to an existing
    cluster (the reference's fake-multinode analog).

    Fault hooks (driven by ``devtools/chaos.py`` injectors, all through
    the real reconcile loop):

    - ``fault_create_errors``: the next N ``create_node`` calls raise —
      the backoff-convergence scenario.
    - ``fault_create_delay_s``: ``create_node`` returns a provider id
      immediately but the node's processes start only after the delay —
      slow provisioning, during which the decision must not
      double-launch.
    - ``kill_node``: kill a node's processes while KEEPING the provider
      record — a crashed VM the cloud API still reports as running; the
      autoscaler's reclaim pass must converge it.
    """

    def __init__(self, cp_address: str, session_id: str):
        self._cp_address = cp_address
        self._session_id = session_id
        self._nodes: Dict[str, tuple] = {}  # provider_id -> (type_name, Node)
        self._lock = threading.Lock()
        self.fault_create_errors = 0
        self.fault_create_delay_s = 0.0
        self.create_calls = 0
        self.terminate_calls = 0

    def create_node(self, node_type: NodeTypeConfig) -> str:
        from ..core.node import Node

        self.create_calls += 1
        with self._lock:
            if self.fault_create_errors > 0:
                self.fault_create_errors -= 1
                raise RuntimeError(
                    "chaos: provider refused create_node "
                    f"({self.fault_create_errors} more failures queued)"
                )
            delay = self.fault_create_delay_s
        provider_id = f"fake-{uuid.uuid4().hex[:8]}"
        labels = dict(node_type.labels)
        labels[NODE_TYPE_LABEL] = node_type.name
        labels[PROVIDER_ID_LABEL] = provider_id
        # The port's Node merges the host's detected cards under these
        # resources: a fake node registers a card only where its type names
        # GPU, or every fake node on a card's host would register it again.
        resources = {"GPU": 0.0, **node_type.resources}
        node = Node(
            head=False,
            cp_address=self._cp_address,
            resources=resources,
            labels=labels,
            session_id=self._session_id,
            num_cpus=resources.get("CPU", 1),
        )
        self._nodes[provider_id] = (node_type.name, node)
        if delay > 0:
            # Slow provisioning: the id exists (non_terminated_nodes
            # reports it — a real cloud shows the VM as PROVISIONING)
            # but the agent joins late.
            timer = threading.Timer(delay, self._deferred_start,
                                    args=(provider_id, node))
            timer.daemon = True
            timer.name = f"rtpu-fake-provision-{provider_id}"
            timer.start()
        else:
            node.start()
        return provider_id

    def _deferred_start(self, provider_id: str, node) -> None:
        with self._lock:
            if provider_id not in self._nodes:
                return  # terminated while provisioning
        try:
            node.start()
        except Exception:  # noqa: BLE001 — raced terminate kills the start
            from ..util import flight_recorder

            flight_recorder.count_suppressed("fake_provider_deferred_start")

    def terminate_node(self, provider_id: str) -> None:
        self.terminate_calls += 1
        with self._lock:
            entry = self._nodes.pop(provider_id, None)
        if entry is not None:
            _, node = entry
            node.pg.kill_all()

    def kill_node(self, provider_id: str) -> None:
        """Chaos: crash the node's processes but keep the provider record
        (the cloud API has not noticed the VM die)."""
        entry = self._nodes.get(provider_id)
        if entry is not None:
            _, node = entry
            node.pg.kill_all()

    def non_terminated_nodes(self) -> Dict[str, str]:
        return {pid: tname for pid, (tname, _) in self._nodes.items()}


class GCEGPUProvider(NodeProvider):
    """GCE GPU provider skeleton: shells out to ``gcloud compute instances``
    to create and delete GPU VMs (reference precedent: the GCP node
    provider, ``autoscaler/_private/gcp/``).  A node type's ``node_config``
    may name ``machine_type``, ``accelerator_type`` and
    ``accelerator_count``.  Requires ``gcloud`` on PATH and is exercised
    only against a real project — tests use ``FakeMultiNodeProvider``."""

    def __init__(
        self,
        project: str,
        zone: str,
        cluster_name: str,
        cp_address: str,
        machine_type: str = "a3-highgpu-1g",
        accelerator_type: str = "nvidia-h100-80gb",
        accelerator_count: int = 1,
        image_family: str = "common-cu124-debian-11",
        image_project: str = "deeplearning-platform-release",
    ):
        import shutil

        if shutil.which("gcloud") is None:
            raise RuntimeError("GCEGPUProvider requires the gcloud CLI")
        self._project = project
        self._zone = zone
        self._cluster = cluster_name
        self._cp_address = cp_address
        self._machine = machine_type
        self._accel = accelerator_type
        self._count = accelerator_count
        self._image_family = image_family
        self._image_project = image_project
        self._nodes: Dict[str, str] = {}

    def _run(self, *args: str) -> str:
        import subprocess

        return subprocess.check_output(
            ["gcloud", *args, f"--project={self._project}",
             f"--zone={self._zone}", "--format=json"],
            text=True,
        )

    def create_node(self, node_type: NodeTypeConfig) -> str:
        provider_id = f"{self._cluster}-{node_type.name}-{uuid.uuid4().hex[:6]}"
        conf = node_type.node_config
        machine = str(conf.get("machine_type", self._machine))
        accel = str(conf.get("accelerator_type", self._accel))
        count = int(conf.get("accelerator_count", self._count))
        startup = (
            f"python -m ray_tpu_torch start --address={self._cp_address} "
            f"--labels '{{\"{NODE_TYPE_LABEL}\": \"{node_type.name}\", "
            f"\"{PROVIDER_ID_LABEL}\": \"{provider_id}\"}}'"
        )
        self._run(
            "compute", "instances", "create", provider_id,
            f"--machine-type={machine}",
            f"--accelerator=type={accel},count={count}",
            # A VM with GPUs cannot live-migrate: it stops for host
            # maintenance instead.
            "--maintenance-policy=TERMINATE",
            f"--image-family={self._image_family}",
            f"--image-project={self._image_project}",
            f"--metadata=startup-script={startup}",
        )
        self._nodes[provider_id] = node_type.name
        return provider_id

    def terminate_node(self, provider_id: str) -> None:
        if provider_id in self._nodes:
            self._run("compute", "instances", "delete", provider_id,
                      "--quiet")
            self._nodes.pop(provider_id, None)

    def non_terminated_nodes(self) -> Dict[str, str]:
        return dict(self._nodes)
