"""Collective types (reference: ray ``python/ray/util/collective/types.py``).

Backends: the reference's two, NCCL (one process per card, the card's own
collectives) and GLOO (one process per rank over TCP, CPU tensors, and
CUDA tensors staged through the host where gloo has no CUDA op), plus a
LOCAL backend that runs the same ops over per-rank tensors that all live
in this process (single-process groups and the CPU tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Backend(str, Enum):
    NCCL = "nccl"  # one process per rank, torch.distributed over NCCL
    GLOO = "gloo"  # one process per rank, torch.distributed over gloo
    LOCAL = "local"  # every rank in this process (single-controller)

    @classmethod
    def normalize(cls, value) -> "Backend":
        if isinstance(value, cls):
            return value
        v = str(value).lower()
        if v in ("nccl", "gpu", "cuda"):
            return cls.NCCL
        if v == "gloo":
            return cls.GLOO
        if v in ("local", "cpu", "host"):
            return cls.LOCAL
        raise ValueError(f"unknown collective backend {value!r}")


class ReduceOp(str, Enum):
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


@dataclass(frozen=True)
class Topology:
    """Physical shape of a collective group for algorithm selection:
    ``world_size`` members arranged as slices of ``ici_size`` members
    each.  One slice (``ici_size == world_size``) means every hop rides
    ICI; multiple slices mean cross-slice hops ride DCN and a two-level
    decomposition (intra-slice reduce-scatter, inter-slice exchange,
    intra-slice all-gather) becomes eligible."""

    world_size: int
    ici_size: int

    def __post_init__(self):
        if self.ici_size < 1 or self.world_size < 1:
            raise ValueError("topology sizes must be >= 1")
        if self.world_size % self.ici_size:
            raise ValueError(
                f"world_size {self.world_size} not divisible by slice size "
                f"{self.ici_size}"
            )

    @property
    def dcn_size(self) -> int:
        return self.world_size // self.ici_size

    @property
    def is_two_level(self) -> bool:
        return 1 < self.ici_size < self.world_size

    @property
    def kind(self) -> str:
        """``"ici"`` when every hop is intra-slice, ``"dcn"`` otherwise."""
        return "ici" if self.dcn_size == 1 else "dcn"


@dataclass
class GroupInfo:
    group_name: str
    world_size: int
    rank: int
    backend: Backend
