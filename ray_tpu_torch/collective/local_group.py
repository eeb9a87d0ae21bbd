"""Single-controller collective group over per-rank tensors in this process.

Port of ``ray_tpu/collective/local_group.py`` (``LocalXlaGroup``), the
counterpart of the reference's single-process multi-GPU collectives (ray
``util/collective``'s ``*_multigpu`` variants backed by cupy-NCCL,
``collective_group/nccl_collective_group.py:121``).  Every rank lives in
this process, rank i's tensor on ``devices[i]``: one card per rank when
the process sees several, and on one card every rank on ``cuda:0``.  The
ops, the algorithm selection and the flight-recorder capture are the JAX
group's; the algorithms exchange per-rank tensors by device copies
(``algorithms.Comm``) and reduce in rank order, as XLA's flat collectives
do.

Input convention: a list of per-rank tensors (numpy arrays are taken too),
one per rank; every op returns one result per rank, on that rank's device.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence

from .types import Backend, GroupInfo, ReduceOp

if TYPE_CHECKING:
    import torch


class _LocalComm:
    """``algorithms.Comm`` over every rank of a ``LocalGroup``: an axis
    exchange is a device copy from each sender's tensor to its receiver's
    device; the flat collectives reduce in rank order."""

    def __init__(self, devices, topology):
        self.devices = devices
        self.topology = topology

    def size(self, axis: str) -> int:
        topo = self.topology
        return {"world": topo.world_size, "ici": topo.ici_size,
                "dcn": topo.dcn_size}[axis]

    def index(self, axis: str) -> List[int]:
        ici = self.topology.ici_size
        return [{"world": r, "ici": r % ici, "dcn": r // ici}[axis]
                for r in range(len(self.devices))]

    def _groups(self, axis: str) -> List[List[int]]:
        """The ranks of each group along ``axis``, in axis order."""
        topo = self.topology
        ici, dcn = topo.ici_size, topo.dcn_size
        if axis == "world":
            return [list(range(topo.world_size))]
        if axis == "ici":
            return [[d * ici + i for i in range(ici)] for d in range(dcn)]
        return [[d * ici + i for d in range(dcn)] for i in range(ici)]

    def _to(self, tensor, rank: int):
        return tensor.to(self.devices[rank], copy=True)

    def ppermute(self, xs, axis: str, perm):
        import torch

        out = [None] * len(xs)
        for members in self._groups(axis):
            for src, dst in perm:
                out[members[dst]] = self._to(xs[members[src]], members[dst])
        # Positions no one sends to receive zeros, as in jax.lax.ppermute.
        return [o if o is not None else torch.zeros_like(x)
                for o, x in zip(out, xs)]

    def _per_group(self, xs, axis: str, combine):
        out = [None] * len(xs)
        for members in self._groups(axis):
            results = combine([xs[m] for m in members])
            for pos, m in enumerate(members):
                out[m] = self._to(results(pos), m)
        return out

    def psum(self, xs, axis: str):
        from .algorithms import sum_ranks

        def combine(parts):
            total = sum_ranks(parts)
            return lambda pos: total

        return self._per_group(xs, axis, combine)

    def psum_scatter(self, xs, axis: str):
        from .algorithms import sum_ranks

        def combine(parts):
            total = sum_ranks(parts)
            rows = total.shape[0] // len(parts)
            return lambda pos: total[pos * rows:(pos + 1) * rows]

        return self._per_group(xs, axis, combine)

    def all_gather(self, xs, axis: str, tiled: bool = False):
        import torch

        def combine(parts):
            dev = parts[0].device
            parts = [p.to(dev) for p in parts]
            whole = torch.cat(parts) if tiled else torch.stack(parts)
            return lambda pos: whole

        return self._per_group(xs, axis, combine)


class LocalGroup:
    """Collective group whose ranks all live in this process."""

    def __init__(self, group_name: str, devices: Sequence = None,
                 slice_size: int = None):
        import torch

        from ..device import resolve_device
        from .types import Topology

        self.group_name = group_name
        if devices is None:
            # One rank per visible card; with none, the device rule raises.
            resolve_device(None)
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self.world_size = len(self.devices)
        # ``slice_size``: ranks per ICI slice.  Default: every rank in one
        # slice (pure-ICI topology).  A multi-slice local group (a CPU
        # group standing in for a 2-slice fabric in tests/bench) unlocks
        # the two-level algorithms.
        self.topology = Topology(self.world_size,
                                 slice_size or self.world_size)
        self._comm = _LocalComm(self.devices, self.topology)
        self._last_decision = None  # tuner decision of the most recent op
        # Flight recorder: op/bytes/world-size/duration + achieved-bandwidth
        # capture on every collective (no-op when disabled).
        from ..util import flight_recorder

        flight_recorder.instrument_group(self, "local")

    def info(self, rank: int = 0) -> GroupInfo:
        return GroupInfo(self.group_name, self.world_size, rank, Backend.LOCAL)

    # ------------------------------------------------------------- plumbing
    def _place(self, tensors: List) -> List["torch.Tensor"]:
        """Rank i's tensor on device i (no copy where it already is)."""
        import torch

        if len(tensors) != self.world_size:
            raise ValueError(
                f"expected {self.world_size} per-rank tensors, got "
                f"{len(tensors)}"
            )
        xs = [torch.as_tensor(t, device=d)
              for t, d in zip(tensors, self.devices)]
        if any(x.shape != xs[0].shape or x.dtype != xs[0].dtype
               for x in xs):
            raise ValueError("per-rank tensors differ in shape or dtype")
        return xs

    def _select(self, op: str, per_rank_nbytes: int, quantized: bool) -> str:
        """Tuner decision for one op call (single-controller group:
        every rank lives in this process, so the tuner's measurement
        table needs no cross-member sync)."""
        from .tuner import select_for_group

        return select_for_group(self, op, per_rank_nbytes, quantized)

    def _resolve_quantized(self, op: ReduceOp, dtype, quantized) -> bool:
        from .algorithms import resolve_quantized

        return resolve_quantized(op, dtype, quantized)

    @staticmethod
    def _quant_block() -> int:
        from ..core.config import GlobalConfig

        return GlobalConfig.collective_quant_block_size

    def _replicate(self, tensor) -> List["torch.Tensor"]:
        return [tensor.to(d, copy=True) for d in self.devices]

    # ------------------------------------------------------------------ ops
    def allreduce(self, tensors: List, op: ReduceOp = ReduceOp.SUM,
                  quantized: bool = None) -> List:
        from . import algorithms as alg

        xs = self._place(tensors)
        quantized = self._resolve_quantized(op, xs[0].dtype, quantized)
        self._last_decision = None

        if op != ReduceOp.SUM:
            # Non-SUM reductions keep the flat lowering (no algorithm
            # family implements reassociation-safe MAX/MIN/MEAN/PRODUCT).
            return self._replicate(alg.flat_reduce(xs, op))

        algo = self._select("allreduce", xs[0].nbytes, quantized)
        comm = self._comm
        if algo in (alg.TWO_LEVEL, alg.TWO_LEVEL_Q8):
            return alg.two_level_allreduce(
                comm, xs, self.topology.ici_size,
                quantized=(algo == alg.TWO_LEVEL_Q8),
                block_size=self._quant_block(),
            )
        if algo == alg.RING:
            return alg.ring_allreduce(comm, xs)
        if algo == alg.TREE:
            return alg.tree_allreduce(comm, xs)
        if algo == alg.FLAT_Q8:
            return alg.quantized_allreduce(comm, xs,
                                           block_size=self._quant_block())
        return comm.psum(xs, "world")

    def allgather(self, tensors: List) -> List[List]:
        from . import algorithms as alg

        xs = self._place(tensors)
        self._last_decision = None
        algo = self._select("allgather", xs[0].nbytes, False)
        if algo == alg.RING:
            stacks = alg.ring_allgather(self._comm, xs)
        else:
            stacks = self._comm.all_gather(xs, "world")
        return [list(s.unbind(0)) for s in stacks]

    def reducescatter(self, tensors: List, op: ReduceOp = ReduceOp.SUM) -> List:
        """Rank i receives chunk i of the elementwise reduction (inputs must
        be divisible by world_size along axis 0)."""
        from . import algorithms as alg

        xs = self._place(tensors)
        n = self.world_size
        self._last_decision = None
        if op == ReduceOp.SUM:
            algo = self._select("reducescatter", xs[0].nbytes, False)
            if algo == alg.RING:
                return alg.ring_reducescatter(self._comm, xs)
            return self._comm.psum_scatter(xs, "world")
        red = alg.flat_reduce(xs, op)
        chunk = red.shape[0] // n
        return [red[r * chunk:(r + 1) * chunk].to(d, copy=True)
                for r, d in enumerate(self.devices)]

    def broadcast(self, tensors: List, src_rank: int = 0) -> List:
        xs = self._place(tensors)
        return self._replicate(xs[src_rank])

    def alltoall(self, tensors: List) -> List:
        """Rank i's output chunk j = rank j's input chunk i (axis 0)."""
        import torch

        xs = self._place(tensors)
        n = self.world_size
        if xs[0].shape[:1] != (n,):
            raise ValueError(
                f"alltoall takes per-rank tensors of {n} chunks on axis 0, "
                f"got shape {tuple(xs[0].shape)}"
            )
        return [torch.stack([xs[j][i].to(d) for j in range(n)])
                for i, d in enumerate(self.devices)]

    def sendrecv_ring(self, tensors: List, shift: int = 1) -> List:
        """ppermute ring shift: rank i's tensor goes to rank (i+shift)%n."""
        n = self.world_size
        perm = [(i, (i + shift) % n) for i in range(n)]
        return self._comm.ppermute(self._place(tensors), "world", perm)

    def barrier(self):
        import torch

        self.allreduce([torch.zeros((1,), dtype=torch.float32, device=d)
                        for d in self.devices])
