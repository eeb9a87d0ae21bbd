"""DataParallelTrainer / JaxTrainer — driver API + control loop.

Reference architecture (ray ``train/v2/api/data_parallel_trainer.py:67,155``
and ``controller/controller.py:102``): fit() drives a controller loop that
creates a WorkerGroup of actors placed by a placement group, runs the
backend's on_start (jax.distributed bootstrap), executes the user
``train_loop_per_worker``, polls reported results/checkpoints, and applies
the failure policy (tear down + recreate from the latest checkpoint, up to
``FailureConfig.max_failures``).

Difference from the reference: the controller runs in the driver process
rather than a detached actor — same state machine, one fewer process hop;
the gang itself is actors with a PG exactly as in the reference.  TPU note:
for slice jobs each worker is one TPU host; one host failing means the whole
ICI mesh restarts, which is exactly the group-restart semantic implemented
here (SURVEY.md §7 "multi-controller SPMD" note).
"""

from __future__ import annotations

import logging
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from .backend import Backend
from .checkpoint import Checkpoint, CheckpointManager
from .config import (
    CollectiveConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class DataParallelTrainer:
    backend_cls = Backend

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend: Optional[Backend] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
        collective_config: Optional[CollectiveConfig] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend = backend or self.backend_cls()
        # Collective-layer opt-ins (quantized gradient allreduce, tuner
        # toggle) applied on every gang member before the user loop.
        self.collective_config = collective_config
        self.resume_from_checkpoint = resume_from_checkpoint
        # Data ingest (reference: the DatasetsCallback + streaming_split):
        # each dataset splits into one lazy shard per worker, read in the
        # worker via ray_tpu_torch.train.get_dataset_shard(name).
        self.datasets = datasets or {}

    def fit(self) -> Result:
        from ray_tpu_torch.core.usage import record_library_usage

        record_library_usage("train")
        storage = self.run_config.storage_path or tempfile.mkdtemp(
            prefix="rtpu_train_"
        )
        ckpt_mgr = CheckpointManager(
            storage,
            self.run_config.name,
            self.run_config.checkpoint_config.num_to_keep,
        )
        if self.resume_from_checkpoint is not None:
            ckpt_mgr.register(self.resume_from_checkpoint.path)
        failure_cfg: FailureConfig = self.run_config.failure_config
        payload = dumps_function(self.train_loop)
        attempts = 0
        metrics_history: List[Dict[str, Any]] = []
        last_error: Optional[BaseException] = None
        resize_events: List[Dict[str, Any]] = []
        prev_world: Optional[int] = None
        # Why the next gang differs in size from the previous one (set
        # before each `continue`/retry; consumed when the event is logged).
        resize_reason = ""

        while attempts <= max(0, failure_cfg.max_failures):
            group = self._create_group_elastic()
            if prev_world is not None and group.num_workers != prev_world:
                from ray_tpu_torch.util import flight_recorder

                direction = (
                    "grow" if group.num_workers > prev_world else "shrink"
                )
                resize_events.append(
                    {
                        "from": prev_world,
                        "to": group.num_workers,
                        "direction": direction,
                        "reason": resize_reason or "worker failure",
                    }
                )
                flight_recorder.record_elastic_resize(direction)
                logger.info(
                    "elastic resize: world %d -> %d (%s)",
                    prev_world, group.num_workers,
                    resize_reason or "worker failure",
                )
            prev_world = group.num_workers
            resize_reason = ""
            try:
                self.backend.on_start(group)
                if self.collective_config is not None:
                    ray_tpu_torch.get(
                        [
                            w.apply_system_config.remote(
                                self.collective_config.as_system_config()
                            )
                            for w in group.workers
                        ],
                        timeout=60,
                    )
                shards_per_worker = None
                if self.datasets:
                    n = group.num_workers
                    split = {
                        name: ds.streaming_split(n)
                        for name, ds in self.datasets.items()
                    }
                    shards_per_worker = [
                        {name: split[name][i] for name in split}
                        for i in range(n)
                    ]
                run_refs = group.run_async(
                    payload, self.train_loop_config, ckpt_mgr.latest(),
                    ckpt_mgr.run_dir, shards_per_worker,
                )
                result, grow_to = self._poll_until_done(
                    group, run_refs, ckpt_mgr, metrics_history
                )
                self.backend.on_shutdown(group)
                group.shutdown()
                if grow_to is not None:
                    # Cooperative stop for a grow offer: the workers
                    # checkpointed and returned cleanly — re-form larger
                    # without consuming a failure attempt.
                    resize_reason = (
                        f"capacity for {grow_to} workers became available"
                    )
                    continue
                result.path = ckpt_mgr.run_dir
                chosen = getattr(self.backend, "chosen", None)
                if chosen:
                    # Which torch.distributed backend the gang ran on.
                    result.metrics = {**result.metrics,
                                      "torch_backend": chosen}
                result.metrics_history = metrics_history
                result.resize_events = resize_events
                return result
            except Exception as e:  # noqa: BLE001 - worker/group failure
                last_error = e
                attempts += 1
                logger.warning(
                    "training attempt failed (%s); %s", e,
                    "retrying from latest checkpoint"
                    if attempts <= failure_cfg.max_failures
                    else "giving up",
                )
                try:
                    group.shutdown()
                except Exception:
                    pass
        return Result(
            metrics=metrics_history[-1] if metrics_history else {},
            checkpoint=ckpt_mgr.latest(),
            path=ckpt_mgr.run_dir,
            error=last_error,
            metrics_history=metrics_history,
            resize_events=resize_events,
        )

    def _create_group_elastic(self) -> WorkerGroup:
        """Gang-create the worker group; if elastic (min_workers set) and
        the full gang cannot be placed, retry with fewer workers — the
        reference's ScalingPolicy resize-on-recovery semantic."""
        cfg = self.scaling_config
        if cfg.min_workers is None or cfg.min_workers >= cfg.num_workers:
            return WorkerGroup(
                cfg.num_workers, cfg.worker_resources(),
                cfg.placement_strategy,
            )
        # Elastic: size the gang to what the cluster can fit right now
        # (cheap feasibility probe against the resource view — no 2-minute
        # PG timeout per candidate size), floored at min_workers.
        res = cfg.worker_resources()
        floor = max(1, cfg.min_workers)

        def probe() -> int:
            avail = ray_tpu_torch.available_resources()
            n = cfg.num_workers
            while n > floor and any(
                avail.get(k, 0.0) < v * n for k, v in res.items()
            ):
                n -= 1
            return n

        n = probe()
        if n < cfg.num_workers:
            # The view may be stale — a just-torn-down gang's resources are
            # still charged until the next heartbeat.  Re-probe after one
            # heartbeat period before committing to a smaller gang.
            from ray_tpu_torch.core.config import GlobalConfig

            time.sleep(GlobalConfig.health_check_period_s * 1.5)
            n = max(n, probe())
        if n < cfg.num_workers:
            logger.warning(
                "elastic downscale: gang of %d (wanted %d) based on "
                "available resources", n, cfg.num_workers,
            )
        return WorkerGroup(n, res, cfg.placement_strategy)

    def _grow_target(self, current: int) -> Optional[int]:
        """Largest gang size (≤ num_workers) the cluster could fit right
        now on top of the running one, or None if no growth is possible."""
        cfg = self.scaling_config
        if cfg.min_workers is None or current >= cfg.num_workers:
            return None
        res = cfg.worker_resources()
        avail = ray_tpu_torch.available_resources()
        extra = cfg.num_workers - current
        while extra > 0 and any(
            avail.get(k, 0.0) < v * extra for k, v in res.items()
        ):
            extra -= 1
        return current + extra if extra > 0 else None

    def _poll_until_done(self, group, run_refs, ckpt_mgr, metrics_history):
        """Poll the gang to completion.  Returns ``(result, grow_to)`` —
        ``grow_to`` is the new world size when the gang was cooperatively
        stopped for an elastic grow, else None."""
        pending = list(run_refs)
        latest_metrics: Dict[str, Any] = {}
        cfg = self.scaling_config
        probe_period = cfg.resize_check_period_s
        last_probe = time.monotonic()
        positive_probes = 0
        grow_to: Optional[int] = None

        def drain():
            nonlocal latest_metrics
            for state in group.poll():
                for item in state["results"]:
                    # Rank-0 metrics are authoritative, as in the reference;
                    # checkpoints were already persisted worker-side.
                    if item["rank"] == 0:
                        latest_metrics = item["metrics"]
                        metrics_history.append(item["metrics"])
            ckpt_mgr.prune()

        while pending:
            drain()
            ready, pending = ray_tpu_torch.wait(
                pending, num_returns=len(pending), timeout=0.2
            )
            for r in ready:
                ray_tpu_torch.get(r, timeout=10)  # surface worker exceptions
            # ---- elastic grow offer: capacity for a larger gang appeared
            if (
                grow_to is None
                and probe_period > 0
                and time.monotonic() - last_probe >= probe_period
            ):
                last_probe = time.monotonic()
                target = self._grow_target(group.num_workers)
                positive_probes = positive_probes + 1 if target else 0
                if target and positive_probes >= max(
                    1, cfg.resize_confirm_probes
                ):
                    # Confirmed twice (a draining node's resources flash
                    # free before it leaves): ask every worker to
                    # checkpoint and return; the fit loop re-forms larger.
                    grow_to = target
                    logger.info(
                        "elastic grow offer: %d -> %d workers; requesting "
                        "cooperative stop", group.num_workers, target,
                    )
                    group.request_stop()
        drain()
        return (
            Result(metrics=latest_metrics, checkpoint=ckpt_mgr.latest()),
            grow_to,
        )


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch.distributed backend
    (reference: ray ``train/v2/torch/torch_trainer.py:18``): NCCL when
    each worker leases a whole card, gloo otherwise
    (``backend.TorchBackend``)."""

    def __init__(self, *args, **kwargs):
        from .backend import TorchBackend

        kwargs.setdefault("backend", TorchBackend())
        super().__init__(*args, **kwargs)


class TensorflowTrainer(DataParallelTrainer):
    """DataParallelTrainer with the TF_CONFIG backend (reference: ray
    ``train/tensorflow/tensorflow_trainer.py``) — the user loop builds a
    ``tf.distribute.MultiWorkerMirroredStrategy()`` and trains
    data-parallel over gRPC collectives."""

    def __init__(self, *args, **kwargs):
        from .backend import TensorflowBackend

        kwargs.setdefault("backend", TensorflowBackend())
        super().__init__(*args, **kwargs)
