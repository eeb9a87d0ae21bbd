"""Multi-slice meshes: an outer cross-slice axis over per-slice meshes —
port of ``ray_tpu/parallel/multislice.py``.

The least chatty axis (pure data parallelism: one gradient sum per step)
goes across slices, on the slow links (DCN between TPU slices; between
nodes, for cards), and model/fsdp/seq traffic stays inside each slice.
The mesh gets an outer ``dcn`` dim over per-slice sub-meshes, and the
logical rules extend ``batch`` over (dcn, data, fsdp), so models need no
changes.  No CUDA device carries a ``slice_index``: ranks are grouped
into equal contiguous chunks, one chunk a slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .mesh import AXES, MeshConfig, mesh_of_ranks
from .sharding import DEFAULT_RULES, LogicalRules

MULTISLICE_AXES = ("dcn",) + AXES

# Logical rules for a dcn-extended mesh: cross-slice traffic is pure data
# parallelism; every other axis stays intra-slice.
MULTISLICE_RULES: LogicalRules = dict(
    DEFAULT_RULES, batch=("dcn", "data", "fsdp")
)


@dataclass
class MultiSliceConfig:
    num_slices: int
    per_slice: MeshConfig

    @property
    def shape(self):
        return (self.num_slices,) + self.per_slice.shape

    @property
    def num_devices(self) -> int:
        return int(self.num_slices * self.per_slice.num_devices)


def group_devices_by_slice(devices: Sequence, num_slices: int):
    """Partition devices (ranks) into slices: equal contiguous chunks, each
    chunk one slice."""
    n = len(devices)
    per = n // num_slices
    if per * num_slices != n:
        raise ValueError(
            f"{n} devices not divisible into {num_slices} slices"
        )
    return [list(devices[i * per:(i + 1) * per]) for i in range(num_slices)]


def build_multislice_mesh(config: MultiSliceConfig,
                          devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` with dims ('dcn', 'data', 'fsdp', 'stage', 'expert',
    'seq', 'model') over ``devices`` (global ranks, all of the world by
    default): the outer dim crosses slices, inner dims stay inside one."""
    import torch.distributed as dist

    devices = list(devices) if devices is not None else list(
        range(dist.get_world_size()))
    if len(devices) != config.num_devices:
        raise ValueError(
            f"multislice mesh {config.shape} needs {config.num_devices} "
            f"devices, have {len(devices)}"
        )
    slices = group_devices_by_slice(devices, config.num_slices)
    return mesh_of_ranks(config.shape, MULTISLICE_AXES,
                         [r for s in slices for r in s])


def default_rules_for_mesh(mesh) -> LogicalRules:
    """Rule table matching the mesh's axes: dcn-extended meshes get the
    multislice batch mapping, plain meshes the default."""
    return MULTISLICE_RULES if "dcn" in mesh.mesh_dim_names else DEFAULT_RULES
