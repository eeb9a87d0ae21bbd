"""Worker group: the gang of training-worker actors.

Reference: ray ``train/v2/_internal/execution/worker_group/worker_group.py``
— N actors placed by a placement group (one per TPU host for slice jobs),
user ``train_loop_per_worker`` running on a thread inside each actor
(``thread_runner.py``), results polled by the controller (``poll.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.placement import (
    PlacementGroup,
    placement_group,
    placement_group_strategy,
    remove_placement_group,
)

from .checkpoint import Checkpoint
from .session import TrainContext, _clear_session, _set_session


def _use_leased_card() -> None:
    """Make the leased card this thread's current device (CUDA keeps the
    current device per thread).  A worker without a lease, or a process
    that sees no card, is left as it is."""
    import os

    if os.environ.get("CUDA_VISIBLE_DEVICES", "") in ("", "-1"):
        return
    import torch

    if torch.cuda.is_available():
        torch.cuda.set_device(0)


@ray_tpu_torch.remote
class TrainWorker:
    """One member of the gang.  max_concurrency=2 so poll()/control methods
    stay responsive while run() executes the user loop."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._results: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._done = False
        self._error: Optional[str] = None
        self._latest_checkpoint: Optional[Checkpoint] = None
        self._stop_requested = False
        self._backend = ""

    # ------------------------------------------------------------ rendezvous
    def get_coordinator_address(self, port: int = 0) -> str:
        import socket

        from ray_tpu_torch.core.rpc import find_free_port

        host = "127.0.0.1"
        try:
            host = socket.gethostbyname(socket.gethostname())
        except Exception:
            pass
        return f"{host}:{port or find_free_port(host)}"

    def init_torch_distributed(self, host: str, port: int, n: int, rank: int,
                               backend: str = "gloo"):
        import torch.distributed as dist

        _use_leased_card()
        dist.init_process_group(
            backend, init_method=f"tcp://{host}:{port}", world_size=n,
            rank=rank,
        )
        self._backend = backend
        return True

    def set_env(self, env: dict) -> bool:
        """Backend hook: export env vars into the worker process (e.g. the
        variables Accelerate/transformers read at Accelerator() time)."""
        import os

        os.environ.update({k: str(v) for k, v in env.items()})
        return True

    def apply_system_config(self, overrides: dict) -> bool:
        """Apply per-gang GlobalConfig overrides (e.g. the trainer's
        CollectiveConfig: quantized allreduce opt-in, autotune toggle)
        before the user loop runs collectives in this process."""
        from ray_tpu_torch.core.config import GlobalConfig

        GlobalConfig.override(**overrides)
        return True

    # -------------------------------------------------------------- run/poll
    def run(self, train_fn_payload: bytes, config: Optional[dict],
            latest_checkpoint, run_dir: Optional[str] = None,
            dataset_shards: Optional[dict] = None) -> bool:
        """Execute the user loop to completion (blocking this call slot)."""
        from ray_tpu_torch.core.serialization import loads_function

        from .checkpoint import commit_to_storage

        train_fn = loads_function(train_fn_payload)

        def report_fn(metrics, checkpoint):
            # Persist the checkpoint synchronously (durable before report()
            # returns), so a crash right after loses nothing.
            if checkpoint is not None and run_dir is not None:
                checkpoint = commit_to_storage(checkpoint, run_dir)
            with self._lock:
                self._results.append(
                    {"metrics": metrics, "checkpoint": checkpoint,
                     "rank": self.rank}
                )

        ctx = TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=0,
            node_rank=self.rank,
            latest_checkpoint=latest_checkpoint,
            dataset_shards=dataset_shards,
            backend=self._backend,
            _report_fn=report_fn,
            _should_stop_fn=lambda: self._stop_requested,
        )
        # The loop runs on this call's thread: give it the leased card.
        _use_leased_card()
        _set_session(ctx)
        try:
            if config is not None:
                train_fn(config)
            else:
                train_fn()
            return True
        finally:
            _clear_session()
            with self._lock:
                self._done = True

    def request_stop(self) -> bool:
        """Elastic resize: ask the user loop (via ``session.should_stop``)
        to checkpoint and return at the next step boundary.  Runs on a
        spare call slot while run() blocks."""
        self._stop_requested = True
        return True

    def poll(self) -> Dict[str, Any]:
        with self._lock:
            results, self._results = self._results, []
            return {"results": results, "done": self._done}


class WorkerGroup:
    def __init__(self, num_workers: int, resources: Dict[str, float],
                 strategy: str = "SPREAD",
                 pg: Optional[PlacementGroup] = None):
        self.num_workers = num_workers
        self.resources = dict(resources)
        self._own_pg = pg is None
        if pg is None and num_workers > 0:
            pg = placement_group(
                [dict(resources) for _ in range(num_workers)],
                strategy=strategy if num_workers > 1 else "PACK",
            )
            pg.ready(timeout=120)
        self.pg = pg
        self.workers = [
            TrainWorker.options(
                num_cpus=resources.get("CPU", 1),
                num_gpus=resources.get("GPU") or None,
                scheduling_strategy=placement_group_strategy(pg, i),
                max_concurrency=4,
            ).remote(i, num_workers)
            for i in range(num_workers)
        ]

    def run_async(self, train_fn_payload: bytes, config, latest_checkpoint,
                  run_dir=None, dataset_shards_per_worker=None):
        return [
            w.run.remote(
                train_fn_payload, config, latest_checkpoint, run_dir,
                dataset_shards_per_worker[i]
                if dataset_shards_per_worker
                else None,
            )
            for i, w in enumerate(self.workers)
        ]

    def poll(self):
        return ray_tpu_torch.get([w.poll.remote() for w in self.workers], timeout=60)

    def request_stop(self):
        """Broadcast the cooperative-stop flag to every worker (the
        elastic-resize offer)."""
        ray_tpu_torch.get(
            [w.request_stop.remote() for w in self.workers], timeout=60
        )

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self._own_pg and self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
