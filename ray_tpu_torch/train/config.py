"""Train configuration dataclasses (reference surface: ray
``python/ray/train/v2/api/config.py`` / ``air/config.py`` — ScalingConfig,
RunConfig, FailureConfig, CheckpointConfig, Result)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    # Elastic lower bound (reference: Train v2 ScalingPolicy): when the
    # cluster cannot gang-schedule num_workers, the trainer retries with
    # fewer, down to min_workers.  None = fixed-size gang.
    min_workers: Optional[int] = None
    # GPU leases (the reference's ``use_gpu``): each worker leases
    # ``gpus_per_worker`` cards, one whole card when left at 0; a share of
    # a card (0.5) is allowed, so several workers can train on one card.
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    gpus_per_worker: float = 0.0
    accelerator_version: str = ""
    placement_strategy: str = "SPREAD"
    # Elastic grow offers: while an under-sized gang trains, the controller
    # probes free capacity every resize_check_period_s; after
    # resize_confirm_probes consecutive probes showing room for a larger
    # gang it requests a cooperative stop (session.should_stop), re-forms
    # at the new size, and resumes from the latest checkpoint.  Shrink
    # rides the existing failure path (a dead worker tears the gang down
    # and _create_group_elastic re-probes).  0 disables grow offers.
    resize_check_period_s: float = 2.0
    resize_confirm_probes: int = 2

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1.0}
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class CollectiveConfig:
    """Collective-layer knobs applied on every training worker before the
    user loop starts (see docs/collective.md).

    ``quantized_allreduce=True`` opts the gang's SUM-allreduces on float
    payloads into the EQuARX-style block-quantized exchange (int8 blocks
    + per-block scales, ~4x fewer wire bytes on the DCN-bound gradient
    path, bounded per-block error).  OFF by default — results are
    bit-exact without it."""

    quantized_allreduce: bool = False
    quant_block_size: int = 256
    # Online algorithm selection (flat/ring/tree/two-level per bucket);
    # False pins the static heuristic table.
    autotune: bool = True

    def as_system_config(self) -> Dict[str, Any]:
        return {
            "collective_quantized_allreduce": self.quantized_allreduce,
            "collective_quant_block_size": self.quant_block_size,
            "collective_autotune": self.autotune,
        }


@dataclasses.dataclass
class PipelineConfig:
    """Pipeline-parallel execution knobs (``ray_tpu_torch.train.pipeline``).

    ``num_stages`` long-lived stage actors are placed one per
    placement-group bundle (one bundle per TPU slice); each training
    step splits the global batch into ``num_microbatches`` microbatches
    streamed through the stages under an interleaved 1F1B schedule.
    ``interleave`` > 1 gives every stage actor that many
    non-contiguous model chunks (virtual stages), shrinking the
    pipeline bubble from (S-1)/(S-1+M) toward (S-1)/(S-1+M·V) at the
    cost of more activation traffic; it requires ``num_microbatches``
    to be a multiple of ``num_stages``.
    """

    num_stages: int = 2
    num_microbatches: int = 4
    interleave: int = 1
    # DP within a stage: shard every microbatch over this many of the
    # stage process's local devices (XLA SPMD inserts the grad psum) —
    # the MPMD-paper composition: PP across slices, DP/TP inside one.
    dp_devices_per_stage: int = 1
    # Synchronized checkpoint cadence (steps); 0 = only the initial one.
    checkpoint_every_n_steps: int = 0
    # How long a stage blocks waiting for a neighbor's tensor before the
    # step is declared failed (drives failure detection latency).
    recv_timeout_s: float = 120.0
    # Per-step driver-side deadline; 0 = derive from recv_timeout_s.
    step_timeout_s: float = 0.0
    # Opt-in block-quantized inter-stage GRADIENT exchange: B-edge pushes
    # (the bandwidth-bound half of the cross-slice DCN traffic) ride as
    # int8 blocks + per-block scales (~4x fewer wire bytes; bounded
    # per-block error — see docs/collective.md).  Activations stay exact.
    quantized_grad_exchange: bool = False
    quant_block_size: int = 256
    # Test hook: {"stage": int, "step": int, "marker": path} — the stage
    # hard-exits at that step unless the marker file already exists
    # (created just before dying, so the restarted actor runs through).
    debug_fail: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.num_stages < 1 or self.num_microbatches < 1:
            raise ValueError("num_stages and num_microbatches must be >= 1")
        if self.interleave < 1:
            raise ValueError("interleave must be >= 1")
        if self.interleave > 1 and self.num_microbatches % self.num_stages:
            raise ValueError(
                "interleaved 1F1B needs num_microbatches divisible by "
                f"num_stages (got {self.num_microbatches} over "
                f"{self.num_stages})"
            )

    @property
    def total_virtual_stages(self) -> int:
        return self.num_stages * self.interleave


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: str = ""
    storage_path: str = ""
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Any]
    path: str = ""
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None
    # Elastic world-size changes over the run: [{"from", "to",
    # "direction", "reason"}] in order.  Empty/None for fixed gangs.
    resize_events: Optional[list] = None
