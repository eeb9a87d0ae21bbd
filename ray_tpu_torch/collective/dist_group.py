"""Multi-process collective group over ``torch.distributed``.

The port's counterpart of ``ray_tpu/collective/xla_group.py`` (``XlaGroup``)
and of the reference's NCCL process group (ray
``util/collective/collective_group/nccl_collective_group.py:121``).  Members
rendezvous through the control-plane KV, as the JAX group does: rank 0
starts a ``TCPStore`` and publishes its address there, the others read it
and connect.  Each group then builds its own process group on that store
(``ProcessGroupNCCL`` or ``ProcessGroupGloo``, constructed directly), so a
group neither needs nor touches torch's default process group: a train
worker whose backend made the default group can make named groups beside
it, and destroying a group frees its communicators.

Each member process calls every op with its own tensor; results come back
as tensors on that tensor's device, as the reference's eager NCCL calls do.

Backends, as asked and never switched quietly:

  ``nccl``  one card per rank; CUDA tensors.  Two ranks on one card is an
            error (NCCL cannot set up a communicator between them), raised
            at construction with the ranks and the card named.
  ``gloo``  CPU tensors, and CUDA tensors: gloo reduces and broadcasts
            CUDA tensors in place, and every other op (the ring and tree
            exchanges, allgather, alltoall, ppermute) has no CUDA path in
            gloo, so the group stages those through host buffers: a copy
            to the host, the op, a copy back to the tensor's card.  Staged
            bytes are counted per op (``staged_bytes``, and
            ``collective_stats()["staged"]``).
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import TYPE_CHECKING, Dict, List, Optional

from .types import Backend, GroupInfo, ReduceOp

if TYPE_CHECKING:
    import torch

logger = logging.getLogger(__name__)

_KV_NAMESPACE = "collective"

# How long a member waits for the others in one op or in setup.
_OP_TIMEOUT_S = 300.0

# gloo's ops that take CUDA tensors; the rest stage through the host.
_GLOO_CUDA_OPS = ("allreduce", "broadcast")


def _kv_rendezvous(group_name: str, rank: int, world_size: int,
                   timeout: float = 60.0):
    """Rank 0 starts the group's ``TCPStore`` and publishes its address in
    the control-plane KV; everyone else polls for it and connects.
    Returns ``(store, address)``."""
    import torch.distributed as dist

    from ..core.core_worker import global_worker

    worker = global_worker()
    key = f"coord:{group_name}"
    wait = datetime.timedelta(seconds=timeout)
    if rank == 0:
        host = "127.0.0.1"
        import socket

        try:
            host = socket.gethostbyname(socket.gethostname())
        except OSError as e:
            # Loopback is correct single-host; multi-host ranks on other
            # machines cannot reach 127.0.0.1, so say so.
            logger.info(
                "hostname resolution failed (%s); publishing loopback "
                "store address %s", e, host,
            )
        store = dist.TCPStore(host, 0, world_size, True, wait,
                              wait_for_workers=False)
        addr = f"{host}:{store.port}"
        worker._run_sync(
            worker.cp.call(
                "kv_put",
                {"namespace": _KV_NAMESPACE, "key": key,
                 "value": addr.encode()},
            )
        )
        return store, addr
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        val = worker._run_sync(
            worker.cp.call("kv_get", {"namespace": _KV_NAMESPACE, "key": key})
        )
        if val is not None:
            addr = val.decode()
            host, port = addr.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world_size, False, wait)
            return store, addr
        time.sleep(0.1)
    raise TimeoutError(f"rendezvous for group {group_name!r} timed out")


def _card_id(device) -> str:
    """A name of the physical card that two processes agree on."""
    import socket

    import torch

    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}:{uuid or props.name}"


class _DistComm:
    """``algorithms.Comm`` for one member: it holds its own rank; an axis
    exchange is a send and a receive on that axis's process group."""

    def __init__(self, group: "DistGroup"):
        self.g = group

    def size(self, axis: str) -> int:
        topo = self.g.topology
        return {"world": topo.world_size, "ici": topo.ici_size,
                "dcn": topo.dcn_size}[axis]

    def index(self, axis: str) -> List[int]:
        r, ici = self.g.rank, self.g.topology.ici_size
        return [{"world": r, "ici": r % ici, "dcn": r // ici}[axis]]

    def ppermute(self, xs, axis: str, perm):
        import torch

        x = xs[0]
        if self.size(axis) == 1:
            return [x.clone()]
        pg = self.g._axis_group(axis)
        me = self.index(axis)[0]
        dst = next((d for s, d in perm if s == me), None)
        src = next((s for s, d in perm if d == me), None)

        def exchange(t):
            t = t.contiguous()
            buf = torch.zeros_like(t)
            if self.g.backend == Backend.NCCL:
                # Both directions in one NCCL group, or the two ranks of
                # an exchange wait on each other's send.
                pg._start_coalescing(t.device)
                if dst is not None:
                    pg.send([t], dst, 0)
                if src is not None:
                    pg.recv([buf], src, 0)
                self.g._wait(pg._end_coalescing(t.device))
                return buf
            sent = pg.send([t], dst, 0) if dst is not None else None
            if src is not None:
                self.g._wait(pg.recv([buf], src, 0))
            if sent is not None:
                self.g._wait(sent)
            return buf

        return [self.g._run("ppermute", x, exchange)]

    def psum(self, xs, axis: str):
        return [self.g._allreduce_on(self.g._axis_group(axis), xs[0],
                                     ReduceOp.SUM)]

    def psum_scatter(self, xs, axis: str):
        n = self.size(axis)
        pos = self.index(axis)[0]
        x = xs[0]
        rows = x.shape[0] // n
        if self.g.backend == Backend.NCCL:
            pg = self.g._axis_group(axis)
            out = x.new_empty((rows, *x.shape[1:]))
            self.g._wait(pg.reduce_scatter(
                [out], [list(x.contiguous().split(rows))]))
            return [out]
        # gloo: a full allreduce (CUDA tensors in place), then this
        # position's part.
        total = self.psum(xs, axis)[0]
        return [total[pos * rows:(pos + 1) * rows].clone()]

    def all_gather(self, xs, axis: str, tiled: bool = False):
        import torch

        n = self.size(axis)
        pg = self.g._axis_group(axis)

        def gather(t):
            t = t.contiguous()
            outs = [torch.empty_like(t) for _ in range(n)]
            self.g._wait(pg.allgather([outs], [t]))
            return torch.cat(outs) if tiled else torch.stack(outs)

        return [self.g._run("allgather", xs[0], gather)]


class DistGroup:
    """One member (process) of a multi-process collective group."""

    def __init__(
        self,
        group_name: str,
        world_size: int,
        rank: int,
        backend="nccl",
        hosts_per_slice: Optional[int] = None,
    ):
        import torch

        from .types import Topology

        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.backend = Backend.normalize(backend)
        if self.backend not in (Backend.NCCL, Backend.GLOO):
            raise ValueError(
                f"DistGroup runs over nccl or gloo, not {self.backend.value}"
            )
        if self.backend == Backend.NCCL:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"collective group {group_name!r}: the nccl backend "
                    "needs a CUDA device and this process sees none"
                )
        # Where the group's own tensors go (barrier, a fetch's landing
        # buffer): the card for nccl; for gloo, the card when this process
        # holds one, else the host, which gloo serves as well.
        if torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        self._timeout = datetime.timedelta(seconds=_OP_TIMEOUT_S)
        self._store, self.coordinator_address = _kv_rendezvous(
            group_name, rank, world_size
        )
        self._check_members()
        self._groups: Dict[str, object] = {
            "world": self._new_pg("world", rank, world_size)
        }
        # ``hosts_per_slice``: group members per slice.  Default: the
        # whole group is one slice.  Multi-slice groups unlock the
        # two-level algorithms, whose inter-slice hop carries
        # 1/hosts_per_slice of the payload.
        self.topology = Topology(world_size, hosts_per_slice or world_size)
        self._comm = _DistComm(self)
        self._last_decision = None
        # Host staging (gloo with CUDA tensors), bytes by op.
        self.staged_bytes: Dict[str, int] = {}
        # Flight recorder: per-op bytes/duration/bandwidth capture.  Ops
        # that select an algorithm are timed to the end of their device
        # work (the recorder synchronizes CUDA outputs).
        from ..util import flight_recorder

        flight_recorder.instrument_group(self, self.backend.value)

    def info(self) -> GroupInfo:
        return GroupInfo(self.group_name, self.world_size, self.rank,
                         self.backend)

    # ------------------------------------------------------------- plumbing
    def _check_members(self):
        """Every member posts its card (NCCL) and waits for the others: a
        barrier before the KV key goes, and the check that no two NCCL
        ranks share a card."""
        mine = _card_id(self.device) if self.backend == Backend.NCCL else ""
        self._store.set(f"member/{self.rank}", mine)
        keys = [f"member/{r}" for r in range(self.world_size)]
        self._store.wait(keys, self._timeout)
        cards = [self._store.get(k).decode() for k in keys]
        if self.rank == 0:
            from ..core.core_worker import global_worker

            worker = global_worker()
            worker._run_sync(worker.cp.call(
                "kv_del", {"namespace": _KV_NAMESPACE,
                           "key": f"coord:{self.group_name}"}))
        if self.backend == Backend.NCCL:
            for r, card in enumerate(cards):
                first = cards.index(card)
                if first != r:
                    raise ValueError(
                        f"collective group {self.group_name!r}: ranks "
                        f"{first} and {r} are on the same card ({card}); "
                        "NCCL cannot set up a communicator between two "
                        "ranks of one device. Give each rank its own card, "
                        "or ask for backend='gloo'"
                    )

    def _new_pg(self, prefix: str, rank: int, size: int):
        import torch.distributed as dist

        store = dist.PrefixStore(f"{self.group_name}/{prefix}/", self._store)
        if self.backend == Backend.NCCL:
            return dist.ProcessGroupNCCL(store, rank, size, self._timeout)
        return dist.ProcessGroupGloo(store, rank, size, self._timeout)

    def _wait(self, work):
        """Waits for one c10d op.  gloo's wait blocks this thread, so it
        takes the group's op timeout.  NCCL's blocks no thread: it orders
        the current stream after the op, and the group's watchdog holds
        the op to the same timeout (given one here, it would poll the host
        until the op is done)."""
        if self.backend == Backend.NCCL:
            return work.wait()
        return work.wait(self._timeout)

    def _axis_group(self, axis: str):
        """The process group along ``axis`` that holds this rank, made on
        first use (every member reaches the same two-level op together)."""
        pg = self._groups.get(axis)
        if pg is None:
            ici = self.topology.ici_size
            d, i = divmod(self.rank, ici)
            if axis == "ici":
                pg = self._new_pg(f"ici{d}", i, ici)
            else:
                pg = self._new_pg(f"dcn{i}", d, self.topology.dcn_size)
            self._groups[axis] = pg
        return pg

    def _tensor(self, tensor) -> "torch.Tensor":
        import torch

        t = torch.as_tensor(tensor)
        if self.backend == Backend.NCCL and not t.is_cuda:
            raise ValueError(
                f"collective group {self.group_name!r} (nccl) takes CUDA "
                f"tensors, got one on {t.device}"
            )
        return t

    def _run(self, op: str, tensor, fn):
        """``fn(tensor)``, through host buffers where gloo has no CUDA path
        for ``op`` (counted in ``staged_bytes``)."""
        if (self.backend == Backend.GLOO and tensor.is_cuda
                and op not in _GLOO_CUDA_OPS):
            self.staged_bytes[op] = (self.staged_bytes.get(op, 0)
                                     + tensor.nbytes)
            return fn(tensor.cpu()).to(tensor.device)
        return fn(tensor)

    def _allreduce_on(self, pg, tensor, op: ReduceOp):
        import torch
        import torch.distributed as dist

        red = {ReduceOp.SUM: dist.ReduceOp.SUM,
               ReduceOp.MEAN: dist.ReduceOp.SUM,
               ReduceOp.MAX: dist.ReduceOp.MAX,
               ReduceOp.MIN: dist.ReduceOp.MIN,
               ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}[op]
        out = tensor.clone(memory_format=torch.contiguous_format)
        opts = dist.AllreduceOptions()
        opts.reduceOp = red
        self._wait(pg.allreduce([out], opts))
        if op == ReduceOp.MEAN:
            out = out / pg.size()
        return out

    # ----------------------------------------------------- tuner plumbing
    def _tuner_sync(self, vec):
        """Allreduce-MEAN of the tuner's measurement table across group
        members, via a dedicated always-flat allreduce (never routed
        through the selection layer — selection must not depend on
        itself).  Called at deterministic commit points, so every member
        reaches this collective at the same point in its call sequence."""
        import numpy as np
        import torch

        device = self.device if self.backend == Backend.NCCL else "cpu"
        t = torch.as_tensor(np.asarray(vec, np.float64), device=device)
        out = self._allreduce_on(self._groups["world"], t, ReduceOp.SUM)
        return out.cpu().numpy() / self.world_size

    def _select(self, op: str, nbytes: int, quantized: bool) -> str:
        from .tuner import select_for_group

        return select_for_group(
            self, op, nbytes, quantized,
            sync=self._tuner_sync if self.world_size > 1 else None,
        )

    def _resolve_quantized(self, op: ReduceOp, dtype, quantized) -> bool:
        from .algorithms import resolve_quantized

        return resolve_quantized(op, dtype, quantized)

    # ------------------------------------------------------------------ ops
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM,
                  quantized: bool = None):
        from . import algorithms as alg
        from ..core.config import GlobalConfig

        x = self._tensor(tensor)
        quantized = self._resolve_quantized(op, x.dtype, quantized)
        self._last_decision = None

        if op != ReduceOp.SUM:
            return self._allreduce_on(self._groups["world"], x, op)

        algo = self._select("allreduce", x.nbytes, quantized)
        block = GlobalConfig.collective_quant_block_size
        comm = self._comm
        if algo in (alg.TWO_LEVEL, alg.TWO_LEVEL_Q8):
            return alg.two_level_allreduce(
                comm, [x], self.topology.ici_size,
                quantized=(algo == alg.TWO_LEVEL_Q8), block_size=block,
            )[0]
        if algo == alg.RING:
            return alg.ring_allreduce(comm, [x])[0]
        if algo == alg.TREE:
            return alg.tree_allreduce(comm, [x])[0]
        if algo == alg.FLAT_Q8:
            return alg.quantized_allreduce(comm, [x], block_size=block)[0]
        return comm.psum([x], "world")[0]

    def allgather(self, tensor):
        from . import algorithms as alg

        x = self._tensor(tensor)
        self._last_decision = None
        algo = self._select("allgather", x.nbytes, False)
        if algo == alg.RING:
            stack = alg.ring_allgather(self._comm, [x])[0]
        else:
            stack = self._comm.all_gather([x], "world")[0]
        return list(stack.unbind(0))

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        from . import algorithms as alg

        x = self._tensor(tensor)
        n = self.world_size
        self._last_decision = None
        if op == ReduceOp.SUM:
            algo = self._select("reducescatter", x.nbytes, False)
            if algo == alg.RING:
                return alg.ring_reducescatter(self._comm, [x])[0]
            return self._comm.psum_scatter([x], "world")[0]
        red = self._allreduce_on(self._groups["world"], x, op)
        chunk = red.shape[0] // n
        return red[self.rank * chunk:(self.rank + 1) * chunk].clone()

    def broadcast(self, tensor, src_rank: int = 0):
        import torch.distributed as dist

        out = self._tensor(tensor).contiguous().clone()
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        opts.rootTensor = 0
        self._wait(self._groups["world"].broadcast([out], opts))
        return out

    def alltoall(self, tensor):
        """Chunk j of the result = rank j's chunk ``rank`` (axis 0)."""
        import torch
        import torch.distributed as dist

        x = self._tensor(tensor)
        if x.shape[:1] != (self.world_size,):
            raise ValueError(
                f"alltoall takes a tensor of {self.world_size} chunks on "
                f"axis 0, got shape {tuple(x.shape)}"
            )

        def a2a(t):
            t = t.contiguous()
            out = torch.empty_like(t)
            self._wait(self._groups["world"].alltoall_base(
                out, t, [], [], dist.AllToAllOptions()))
            return out

        return self._run("alltoall", x, a2a)

    def ppermute(self, tensor, shift: int = 1):
        n = self.world_size
        perm = [(i, (i + shift) % n) for i in range(n)]
        return self._comm.ppermute([self._tensor(tensor)], "world", perm)[0]

    def barrier(self):
        import torch

        self.allreduce(torch.zeros((1,), dtype=torch.float32,
                                   device=self.device))

    def shutdown(self):
        """Free this member's communicators and its store connection."""
        for pg in self._groups.values():
            close = getattr(pg, "shutdown", None)
            if close is not None:
                close()
        self._groups.clear()
        self._store = None
