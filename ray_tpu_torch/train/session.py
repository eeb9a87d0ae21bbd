"""Per-worker training session: the user-facing ``report`` /
``get_checkpoint`` / ``get_context`` API (reference: ray
``python/ray/train/v2/api/train_fn_utils.py:22,153``).

``report`` hands metrics (and optionally a checkpoint directory) to the
worker actor, which queues them for the controller's poll loop.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint

_session = threading.local()


@dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    node_rank: int
    trial_name: str = ""
    latest_checkpoint: Optional[Checkpoint] = None
    # Per-worker dataset shards (reference: the DatasetsCallback's
    # streaming_split delivery; ray ``train/v2``).
    dataset_shards: Optional[dict] = None
    # torch.distributed backend of the gang's default process group
    # ("nccl" or "gloo"; "" when the trainer's backend started none).
    backend: str = ""
    # filled by the worker actor:
    _report_fn: Any = None
    _should_stop_fn: Any = None


def _set_session(ctx: TrainContext):
    _session.ctx = ctx


def _clear_session():
    _session.ctx = None


def get_context() -> TrainContext:
    ctx = getattr(_session, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "No train session active — call inside train_loop_per_worker"
        )
    return ctx


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    ctx = get_context()
    if ctx._report_fn is not None:
        ctx._report_fn(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().latest_checkpoint


def should_stop() -> bool:
    """True once the controller asked this worker to stop cooperatively —
    the elastic-resize offer.  A loop that honors it (checkpoint via
    ``report``, then return) lets the trainer re-form the gang at a new
    world size and resume from that checkpoint; a loop that ignores it
    simply runs to completion."""
    ctx = get_context()
    if ctx._should_stop_fn is None:
        return False
    return bool(ctx._should_stop_fn())


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the trainer via
    ``datasets={name: ds}`` (reference: ``ray.train.get_dataset_shard``;
    the shard is a ``DataIterator`` whose transforms run worker-side)."""
    ctx = get_context()
    shards = ctx.dataset_shards or {}
    if name not in shards:
        raise KeyError(
            f"no dataset shard {name!r}; trainer datasets: {sorted(shards)}"
        )
    return shards[name]
