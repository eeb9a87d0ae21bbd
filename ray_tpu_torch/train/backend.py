"""Training backends: per-framework distributed-runtime setup.

Reference: ray ``python/ray/train/backend.py`` (Backend.on_start/on_shutdown)
and the torch backend at ``train/torch/config.py:73-122`` (rank 0 picks the
rendezvous address, every worker calls ``init_process_group``).  The
JAX package's default, ``JaxBackend`` (``jax.distributed``), has no
counterpart here: ``TorchBackend`` takes its role.
"""

from __future__ import annotations

from typing import Optional


class Backend:
    def on_start(self, worker_group) -> None:  # noqa: D401
        pass

    def on_shutdown(self, worker_group) -> None:
        pass


class TorchBackend(Backend):
    """torch.distributed's default process group across the gang
    (reference: ray ``train/torch/config.py:73-122``).  ``backend=None``
    picks NCCL when each worker leases at least one whole card and gloo
    otherwise, as the reference's ``TorchConfig`` does; ``"nccl"`` or
    ``"gloo"`` is taken as asked.  The choice is ``chosen``, and it reaches
    each worker's ``TrainContext.backend``."""

    def __init__(self, backend: Optional[str] = None):
        self.backend = backend
        self.chosen: Optional[str] = None

    def on_start(self, worker_group):
        import ray_tpu_torch

        gpus = worker_group.resources.get("GPU", 0.0)
        self.chosen = self.backend or ("nccl" if gpus >= 1 else "gloo")
        n = len(worker_group.workers)
        addr = ray_tpu_torch.get(
            worker_group.workers[0].get_coordinator_address.remote(0),
            timeout=60,
        )
        host, port = addr.rsplit(":", 1)
        ray_tpu_torch.get(
            [
                w.init_torch_distributed.remote(host, int(port), n, rank,
                                                self.chosen)
                for rank, w in enumerate(worker_group.workers)
            ],
            timeout=300,
        )


class TensorflowBackend(Backend):
    """TF_CONFIG-based MultiWorkerMirroredStrategy setup (reference:
    ray ``train/tensorflow/config.py`` ``_setup_tensorflow_environment``).
    Each worker reserves its own port; every rank gets the same cluster
    spec with itself as ``task.index``, so a
    ``tf.distribute.MultiWorkerMirroredStrategy()`` constructed inside
    ``train_loop_per_worker`` rendezvouses over gRPC without any other
    launcher."""

    def on_start(self, worker_group):
        import json

        import ray_tpu_torch

        workers = worker_group.workers
        addrs = ray_tpu_torch.get(
            [w.get_coordinator_address.remote(0) for w in workers],
            timeout=60,
        )
        ray_tpu_torch.get(
            [
                w.set_env.remote({
                    "TF_CONFIG": json.dumps({
                        "cluster": {"worker": list(addrs)},
                        "task": {"type": "worker", "index": rank},
                    }),
                    # Silence TF's GPU probing on CPU/TPU-host workers.
                    "CUDA_VISIBLE_DEVICES": "-1",
                })
                for rank, w in enumerate(workers)
            ],
            timeout=60,
        )


class AccelerateBackend(TorchBackend):
    """HuggingFace Accelerate over the torch gloo group (reference:
    ray ``train/huggingface/accelerate`` integration).  The torch process
    group is bootstrapped exactly like TorchBackend; workers additionally
    get the env Accelerate reads so ``accelerate.Accelerator()`` inside
    ``train_loop_per_worker`` picks up the already-initialized group (and
    a ``transformers.Trainer`` built there trains data-parallel)."""

    def on_start(self, worker_group):
        import ray_tpu_torch

        n = len(worker_group.workers)
        addr = ray_tpu_torch.get(
            worker_group.workers[0].get_coordinator_address.remote(0),
            timeout=60,
        )
        host, port = addr.rsplit(":", 1)
        # Env FIRST: Accelerate's launcher checks MASTER_ADDR/RANK even
        # when torch.distributed is already initialized.
        ray_tpu_torch.get(
            [
                w.set_env.remote(
                    {
                        "ACCELERATE_USE_CPU": "true",
                        "MASTER_ADDR": host,
                        "MASTER_PORT": port,
                        "RANK": str(rank),
                        "WORLD_SIZE": str(n),
                        "LOCAL_RANK": "0",
                    }
                )
                for rank, w in enumerate(worker_group.workers)
            ],
            timeout=60,
        )
        ray_tpu_torch.get(
            [
                w.init_torch_distributed.remote(host, int(port), n, rank)
                for rank, w in enumerate(worker_group.workers)
            ],
            timeout=300,
        )
