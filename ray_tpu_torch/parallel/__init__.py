"""Meshes, logical sharding, and the sequence- and pipeline-parallel
bodies of the port — port of ``ray_tpu/parallel``.  One process is one
mesh rank (``torch.distributed``: gloo on the CPU, NCCL on cards); the
bodies also run single-controller over a ``LocalGroup``."""

from .mesh import AXES, MeshConfig, build_mesh, local_mesh  # noqa: F401
from .multislice import (  # noqa: F401
    MULTISLICE_RULES,
    MultiSliceConfig,
    build_multislice_mesh,
    default_rules_for_mesh,
    group_devices_by_slice,
)
from .pipeline import pipeline_local, pipelined  # noqa: F401
from .ring_attention import ring_attention, ring_attention_local  # noqa: F401
from .sharding import (  # noqa: F401
    DEFAULT_RULES,
    LogicalRules,
    logical_sharding,
    logical_spec,
    shard_pytree,
    sharding_tree,
    with_logical_constraint,
)
from .ulysses import ulysses_attention, ulysses_attention_local  # noqa: F401
