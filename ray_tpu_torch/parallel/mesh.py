"""Device-mesh construction for DP/FSDP/TP/SP/PP — port of
``ray_tpu/parallel/mesh.py``.

The mesh is the unit of parallelism, with the JAX package's six axes:

  - ``data``:  pure data parallelism (gradient sum over the axis)
  - ``fsdp``:  parameter/optimizer sharding (ZeRO-3 style all-gather)
  - ``model``: tensor parallelism (matmul-sharded, psum on contraction)
  - ``seq``:   sequence/context parallelism (ring attention / Ulysses)
  - ``stage``: pipeline parallelism
  - ``expert``: expert parallelism (MoE dispatch via all_to_all)

Each mesh position is one process of the current ``torch.distributed``
world (gloo on the CPU, NCCL on the cards), and ``build_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the axis
names, so ``mesh.get_group("seq")`` is the process group of one axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

AXES = ("data", "fsdp", "stage", "expert", "seq", "model")


@dataclass
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.fsdp, self.stage, self.expert, self.seq,
                self.model)

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    @classmethod
    def for_devices(cls, n: int, *, model: int = 1, seq: int = 1, stage: int = 1,
                    expert: int = 1, fsdp: Optional[int] = None) -> "MeshConfig":
        """Fill the data/fsdp axes with whatever ``n`` leaves after the
        explicitly requested axes."""
        fixed = model * seq * stage * expert
        rest = n // fixed
        if rest * fixed != n:
            raise ValueError(
                f"{n} devices not divisible by model×seq×stage×expert = "
                f"{fixed}"
            )
        if fsdp is None:
            fsdp = rest
            data = 1
        else:
            data = rest // fsdp
            if data * fsdp != rest:
                raise ValueError(f"fsdp={fsdp} does not divide {rest}")
        return cls(data=data, fsdp=fsdp, stage=stage, expert=expert, seq=seq,
                   model=model)


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_of_ranks(shape: Sequence[int], names: Sequence[str],
                  ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over ``ranks`` of
    the current process group (all of them, in order, by default).  Every
    rank of the world calls it, as every rank builds each axis's group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs torch.distributed.init_process_group first "
            "(one process per mesh position)"
        )
    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    need = int(np.prod(shape))
    if len(ranks) != need:
        raise ValueError(
            f"mesh {tuple(shape)} needs {need} devices, have {len(ranks)}"
        )
    return DeviceMesh(_device_type(),
                      torch.tensor(ranks, dtype=torch.int64).reshape(
                          tuple(shape)),
                      mesh_dim_names=tuple(names))


def build_mesh(config: MeshConfig, devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` with all six axes (size-1 axes are free) over the
    current process group; ``devices`` are global ranks, all of the world
    by default."""
    return mesh_of_ranks(config.shape, AXES, devices)


def local_mesh(**axis_sizes):
    """Convenience: mesh over the whole world, e.g.
    ``local_mesh(model=2)`` → the fsdp axis absorbs the rest."""
    import torch.distributed as dist

    cfg = MeshConfig.for_devices(dist.get_world_size(), **axis_sizes)
    return build_mesh(cfg)


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (``mesh.shape[name]`` in JAX)."""
    return mesh.size(mesh.mesh_dim_names.index(name))
