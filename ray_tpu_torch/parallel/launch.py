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
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

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
        failed: Optional[int] = None
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            time.sleep(0.05)
        timed_out = failed is None and any(p.poll() is None for p in procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None and not timed_out:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        if timed_out:
            raise TimeoutError(f"{fn}: world of {n} passed its {timeout:.0f}"
                               f" s deadline\n"
                               f"{_tail(os.path.join(work, 'rank0.log'))}")
        if failed is not None:
            # Every rank that exited with an error (-9 is this call's
            # kill): the first to raise takes its peers down with it, in
            # no set order.
            tails = "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n"
                f"{_tail(os.path.join(work, f'rank{r}.log'))}"
                for r, p in enumerate(procs) if p.returncode not in (0, -9))
            raise RuntimeError(f"{fn}: rank {failed} exited "
                               f"{procs[failed].returncode}\n{tails}")
        out = []
        for rank in range(n):
            with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
