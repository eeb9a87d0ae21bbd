"""Run one function as an SPMD world of fresh processes, one a mesh rank.

``run_world("pkg.module:fn", n, args=(...))`` starts ``n`` processes
(``python -m ray_tpu_torch.parallel.launch``), joins them into one
``torch.distributed`` process group over a ``FileStore`` in a directory of
its own (so two worlds never meet), calls ``fn(*args)`` in each, and
returns the ranks' results in rank order.  The whole world runs under one
deadline: past it every process is killed and ``TimeoutError`` raised, so
a hung collective fails one call instead of blocking its caller.  A rank
that raises fails the call with that rank's error output.

The ranks are gloo processes on the CPU, one intra-op thread each, or
with ``backend="nccl"`` one process a card (rank r on ``cuda:r``).  NCCL
refuses two ranks on one card, so on one card a mesh is a world of one.
``backend_for(device, n)`` picks the backend by the port's device rule,
and ``rank_device()`` is a rank's own device inside ``fn``.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

# How long the other ranks may take to exit on their own once one fails.
_GRACE_S = 5.0
# A collective's errors when a peer process exits (gloo, NCCL).
_PEER_CLOSED = re.compile(r"[Cc]onnection (closed|reset) by peer|Broken pipe"
                          r"|ncclRemoteError|remote process exited")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def backend_for(device, n: int) -> str:
    """The backend of a world of ``n`` ranks on ``device`` (the port's
    rule: ``None`` is the cards): gloo for the CPU; NCCL for the cards,
    one a rank, raising when fewer than ``n`` are present."""
    import torch

    from ..device import resolve_device

    if resolve_device(device).type == "cpu":
        return "gloo"
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a world of {n} ranks needs {n} cards, have "
                           f"{have}; pass device='cpu' for gloo processes "
                           f"on the CPU")
    return "nccl"


def rank_device():
    """This rank's device: its card under NCCL, the CPU under gloo."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def run_world(fn: str, n: int, *, args: Sequence[Any] = (),
              timeout: float = 300.0, paths: Sequence[str] = (),
              backend: str = "gloo") -> List[Any]:
    """Results of ``fn(*args)`` on each of ``n`` ranks.  ``fn`` is
    "module:function", importable from the checkout or from ``paths``."""
    work = tempfile.mkdtemp(prefix="spmd_world_")
    try:
        with open(os.path.join(work, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args), backend), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO, *paths, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        env["OMP_NUM_THREADS"] = "1"
        procs = []
        for rank in range(n):
            log = open(os.path.join(work, f"rank{rank}.log"), "wb")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.parallel.launch",
                 work, str(rank), str(n)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
            log.close()
        deadline = time.monotonic() + timeout
        # Ranks seen to exit with an error, in the order seen.  The first
        # failure starts a grace for the rest: a peer's collective raises
        # as soon as the failing rank closes its connections, and may
        # exit before it, so each rank gets a moment to exit on its own
        # and leave its own error in its log.
        exited: List[int] = []
        grace_end: Optional[float] = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if now > deadline or (grace_end is not None and now > grace_end):
                break
            exited += [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0) and r not in exited]
            if exited and grace_end is None:
                grace_end = min(deadline, now + _GRACE_S)
            time.sleep(0.05)
        exited += [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0) and r not in exited]
        timed_out = not exited and any(p.poll() is None for p in procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if timed_out:
            raise TimeoutError(f"{fn}: world of {n} passed its {timeout:.0f}"
                               f" s deadline\n"
                               f"{_tail(os.path.join(work, 'rank0.log'))}")
        if exited:
            logs = [os.path.join(work, f"rank{r}.log") for r in range(n)]
            # The rank whose log shows the first error of its own (one not
            # raised by a collective at a peer's exit), a rank killed here
            # included; else the lowest rank that failed.
            killed = [r for r, p in enumerate(procs)
                      if p.returncode and r not in exited]
            failed = next((r for r in exited + killed
                           if _own_error(logs[r])), min(exited))
            tails = "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n{_tail(logs[r])}"
                for r, p in enumerate(procs) if p.returncode)
            raise RuntimeError(f"{fn}: rank {failed} exited "
                               f"{procs[failed].returncode}\n{tails}")
        out = []
        for rank in range(n):
            with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _own_error(path: str) -> bool:
    """Whether the rank's log ends in a raised exception of its own, and
    not in a collective's error at a peer's exit."""
    text = _tail(path, 20000)
    at = text.rfind("Traceback (most recent call last)")
    return at >= 0 and not _PEER_CLOSED.search(text[at:])


def _tail(path: str, size: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-size:].decode(errors="replace")
    except OSError:
        return ""


def _main(work: str, rank: int, n: int) -> None:
    import importlib

    import torch.distributed as dist

    with open(os.path.join(work, "call.pkl"), "rb") as f:
        fn, args, backend = pickle.load(f)
    if backend == "nccl":
        import torch

        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(work, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        module, name = fn.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
