"""``ray_tpu_torch.autoscaler`` — reconciler-style cluster autoscaling.

Role-equivalent of the reference's autoscaler v2 (ray
``python/ray/autoscaler/v2/autoscaler.py:50``): a reconciler polls the
control plane's load state (pending actors / placement groups / queued
leases / explicit requests), bin-packs unmet demand onto configured node
types, and drives a ``NodeProvider`` to launch/terminate nodes.  The TPU
twist: node types are *slices* — a ``TPU-v5e-8`` node type launches a whole
host with its chips, and gang demands (placement groups) are packed
slice-atomically.
"""

from .config import AutoscalingConfig, NodeTypeConfig  # noqa: F401
from .autoscaler import Autoscaler, wait_for_nodes  # noqa: F401
from .elastic import LaunchBackoff, NodeDrainer  # noqa: F401
from .command_runner import (  # noqa: F401
    CommandRunner,
    LocalCommandRunner,
    ManagedVMProvider,
    SSHCommandRunner,
)
from .provider import FakeMultiNodeProvider, NodeProvider  # noqa: F401
from .sdk import request_resources  # noqa: F401
