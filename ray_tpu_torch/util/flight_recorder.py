"""Runtime flight recorder: built-in task-phase, collective, and
backpressure telemetry.

The runtime's own observability layer (the user-facing spans/metrics live
in ``util/tracing.py`` / ``util/metrics.py``; this module instruments the
runtime itself).  Everything lands in the existing metrics registry under
``ray_tpu_*`` names — so it flows through the cluster KV merge, the
``/metrics`` Prometheus endpoint, and ``metrics.snapshot()`` — and task
phases additionally ride the task-event profile channel so they render as
rows in the Chrome-trace ``/api/timeline`` dump.

What gets recorded (all gated on ``GlobalConfig.enable_flight_recorder``;
``bench.py obs_overhead`` guards the cost at <5% of the task round trip):

  - per-task phase timings on the executing worker — queue wait (push
    arrival -> execution start, including function fetch and pipeline
    sequencing), argument resolution, execution, return packaging — as
    the ``ray_tpu_task_phase_s{phase=...}`` histogram plus one
    ``phase:<name>`` profile row per phase;
  - submission backpressure waits (``_SubmitBudget`` blocks) as the
    ``ray_tpu_backpressure_wait_s`` histogram + blocked counter;
  - every collective op (allreduce/allgather/reducescatter/broadcast/
    alltoall/permute) with op, bytes, world size, duration, and an
    achieved-bandwidth histogram (EQuARX-style per-op accounting);
  - the ICI scaling-efficiency gauge fed by
    ``parallel/scaling_bench.py``'s partition-retention measurements;
  - object-store accounting (arena usage, spill bytes written/reclaimed,
    LRU evictions, ``ObjectStoreFullError`` occurrences) and node-agent
    lease-grant waits / queue depth.

Percentile summaries of the phase rows are served by
``ray_tpu_torch.util.state.summarize_task_phases()``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

from ..core.config import GlobalConfig
from . import metrics as _metrics

# Metric names live in ONE registry module (raylint RTL004); the common
# ones are re-exported here for the recorder's callers and tests.
from .metric_registry import (  # noqa: F401 — re-exports
    AUTOSCALER_DRAIN_DURATION_HIST,
    AUTOSCALER_DRAINS_TOTAL,
    AUTOSCALER_LAUNCHES_TOTAL,
    AUTOSCALER_PENDING_DEMAND,
    AUTOSCALER_TERMINATIONS_TOTAL,
    BACKPRESSURE_BLOCKED_TOTAL,
    BACKPRESSURE_WAIT_HIST,
    COLLECTIVE_ALGO_OPS_TOTAL,
    COLLECTIVE_BANDWIDTH_HIST,
    COLLECTIVE_BYTES_TOTAL,
    COLLECTIVE_DURATION_HIST,
    COLLECTIVE_OPS_TOTAL,
    COLLECTIVE_QUANTIZED_BYTES_SAVED_TOTAL,
    COLLECTIVE_QUANTIZED_OPS_TOTAL,
    COLLECTIVE_TUNER_BEST_BANDWIDTH,
    COLLECTIVE_TUNER_COMMITS_TOTAL,
    COLLECTIVE_TUNER_EXPLORATIONS_TOTAL,
    CP_FAILOVERS_TOTAL,
    CP_JOURNAL_LAG_RECORDS,
    CP_JOURNAL_RECORDS_TOTAL,
    CP_LEASE_EPOCH,
    CP_ROLE,
    DATA_AUTOSCALE_EVENTS_TOTAL,
    DATA_BLOCKS_COALESCED_TOTAL,
    DATA_BLOCKS_EMITTED_TOTAL,
    DATA_BLOCKS_SPLIT_TOTAL,
    DATA_POOL_SIZE,
    DATA_QUEUE_DEPTH,
    DATA_STRAGGLER_WAIT_HIST,
    EXCEPTION_SUPPRESSED_TOTAL,
    GET_BATCH_CALLS_TOTAL,
    GET_BATCH_REFS_TOTAL,
    ICI_SCALING_EFFICIENCY,
    LOCATION_CACHE_HITS_TOTAL,
    LOCATION_CACHE_INVALIDATIONS_TOTAL,
    LOCATION_CACHE_MISSES_TOTAL,
    OWNER_SHARD_FAST_ENTRIES_TOTAL,
    OWNER_SHARD_FORWARDED_ENTRIES_TOTAL,
    OWNER_SHARD_LOOKUPS_TOTAL,
    OWNER_SHARD_OBJECTS_MAX,
    PIPELINE_ACTIVATION_BANDWIDTH_HIST,
    PIPELINE_ACTIVATION_BYTES_TOTAL,
    PIPELINE_BUBBLE_FRACTION,
    PIPELINE_MICROBATCHES_TOTAL,
    PIPELINE_STAGE_BWD_HIST,
    PIPELINE_STAGE_FWD_HIST,
    PIPELINE_STAGE_RESTARTS_TOTAL,
    PIPELINE_STAGE_STALL_HIST,
    PG_COMMIT_BATCHED_GROUPS_TOTAL,
    PG_COMMIT_BATCHES_TOTAL,
    PG_COMMIT_FUSED_TOTAL,
    PG_COMMIT_ROLLBACKS_TOTAL,
    REMEDIATION_ACTIONS_TOTAL,
    REMEDIATION_QUARANTINED,
    RPC_BATCH_FRAMES_TOTAL,
    RPC_BATCHED_CALLS_TOTAL,
    RPC_LANE_CONNECTIONS,
    RPC_LANE_DISPATCH_WAIT_HIST,
    RPC_LANE_FORWARDED_TOTAL,
    RPC_LANE_FRAMES_TOTAL,
    RPC_LANE_QUEUE_DEPTH,
    RL_ENV_STEPS_PER_S,
    RL_ENV_STEPS_TOTAL,
    RL_LEARNER_STEPS_PER_S,
    RL_LEARNER_UPDATES_TOTAL,
    RL_PARAM_BROADCAST_BYTES_TOTAL,
    RL_PARAM_STALENESS_HIST,
    RL_RUNNER_RESTARTS_TOTAL,
    RL_STALE_TRAJS_DROPPED_TOTAL,
    RL_TRAJ_QUEUE_DEPTH,
    RPC_OOB_BYTES_TOTAL,
    RPC_OOB_FRAMES_TOTAL,
    SCHED_ADMISSION_QUEUED_TOTAL,
    SCHED_PREEMPTION_VICTIMS_TOTAL,
    SCHED_PREEMPTIONS_DENIED_TOTAL,
    SCHED_PREEMPTIONS_TOTAL,
    LLM_ADMITTED_TOTAL,
    LLM_BATCH_BUCKET,
    LLM_BATCH_OCCUPANCY,
    LLM_DECODE_STEPS_TOTAL,
    LLM_PREEMPTIONS_TOTAL,
    LLM_PREFIX_CACHE_HITS_TOTAL,
    LLM_PREFIX_CACHE_MISSES_TOTAL,
    LLM_QUEUE_DEPTH,
    LLM_RETIRED_TOTAL,
    SERVE_AUTOSCALE_EVENTS_TOTAL,
    SERVE_INTER_TOKEN_HIST,
    SERVE_MUX_CACHE_EVENTS_TOTAL,
    SERVE_QUEUE_WAIT_HIST,
    SERVE_REPLICAS,
    SERVE_REQUESTS_TOTAL,
    SERVE_TTFT_HIST,
    SLO_VIOLATIONS_TOTAL,
    TASK_EVENTS_DROPPED_TOTAL,
    TASK_PHASE_HIST,
    TASKS_CANCELLED_TOTAL,
    TRACE_SPANS_DROPPED_TOTAL,
    TRAIN_ELASTIC_RESIZES_TOTAL,
)

# Sub-millisecond to minutes: runtime phases span five orders of magnitude.
DURATION_BOUNDARIES = [
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
    1.0, 5.0, 10.0, 60.0,
]
# Achieved bytes/s: host-loopback KB/s through multi-slice ICI TB/s.
BANDWIDTH_BOUNDARIES = [
    1e4, 1e5, 1e6, 1e7, 1e8, 5e8, 1e9, 5e9, 1e10, 5e10, 1e11, 1e12,
]

# Canonical executor-side phase names (timeline rows + histogram tags).
TASK_PHASES = ("queue_wait", "arg_resolution", "execute", "return_put")


def enabled() -> bool:
    return GlobalConfig.enable_flight_recorder


# ------------------------------------------------------- generic recorders
def counter(name: str, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
    if not GlobalConfig.enable_flight_recorder or value <= 0:
        return
    _metrics._record(name, "counter", tags or {}, float(value))


def gauge(name: str, value: float,
          tags: Optional[Dict[str, str]] = None) -> None:
    if not GlobalConfig.enable_flight_recorder:
        return
    _metrics._record(name, "gauge", tags or {}, float(value))


def histogram(name: str, value: float, tags: Optional[Dict[str, str]] = None,
              boundaries=None) -> None:
    if not GlobalConfig.enable_flight_recorder:
        return
    _metrics._record(name, "histogram", tags or {}, float(value),
                     buckets=boundaries or DURATION_BOUNDARIES)


def count_suppressed(site: str) -> None:
    """Account one intentionally swallowed exception (RTL003): cleanup
    paths that must not raise still leave a per-site counter trail."""
    counter(EXCEPTION_SUPPRESSED_TOTAL, 1.0, {"site": site})


# ---------------------------------------------------- data-plane fast path
# Published as counter DELTAS at each metrics flush (heartbeat + exit):
# the hot paths themselves bump plain ints (rpc.FRAME_STATS, CoreWorker
# batch/location-cache fields) so per-get/per-frame cost stays at an
# integer increment, not a registry lock round trip.
_dp_published: Dict[str, float] = {}


def record_data_plane(worker) -> None:
    """Publish data-plane fast-path counters accumulated since the last
    flush: v2-framing out-of-band/batch frame stats plus the worker's
    batched-get and owner-location-cache accounting."""
    if not GlobalConfig.enable_flight_recorder:
        return
    from ..core.rpc import FRAME_STATS

    cache = getattr(worker, "_loc_cache", None)
    owned = getattr(worker, "owned", None)
    totals = {
        RPC_OOB_FRAMES_TOTAL: FRAME_STATS["oob_frames"],
        RPC_OOB_BYTES_TOTAL: FRAME_STATS["oob_bytes"],
        RPC_BATCH_FRAMES_TOTAL: FRAME_STATS["batch_frames"],
        RPC_BATCHED_CALLS_TOTAL: FRAME_STATS["batched_calls"],
        GET_BATCH_CALLS_TOTAL: getattr(worker, "_batch_get_calls", 0),
        GET_BATCH_REFS_TOTAL: getattr(worker, "_batch_get_refs", 0),
        LOCATION_CACHE_HITS_TOTAL: cache.hits if cache else 0,
        LOCATION_CACHE_MISSES_TOTAL: cache.misses if cache else 0,
        LOCATION_CACHE_INVALIDATIONS_TOTAL: (
            cache.invalidations if cache else 0
        ),
        OWNER_SHARD_LOOKUPS_TOTAL: (
            sum(owned.lookups) if hasattr(owned, "lookups") else 0
        ),
        OWNER_SHARD_FAST_ENTRIES_TOTAL: getattr(
            worker, "_shard_fast_entries", 0
        ),
        OWNER_SHARD_FORWARDED_ENTRIES_TOTAL: getattr(
            worker, "_shard_forwarded_entries", 0
        ),
    }
    for name, total in totals.items():
        delta = total - _dp_published.get(name, 0)
        if delta > 0:
            _dp_published[name] = total
            counter(name, delta)
    if hasattr(owned, "shard_sizes"):
        sizes = owned.shard_sizes()
        gauge(OWNER_SHARD_OBJECTS_MAX, max(sizes) if sizes else 0)
    record_rpc_lanes(getattr(worker, "server", None), role=worker.mode)


# ------------------------------------------------ multi-lane RPC services
# Same delta-publication pattern: lanes bump plain per-lane accumulators
# on the frame path; the metrics flush turns them into registry samples.
_lane_published: Dict[tuple, dict] = {}


def record_rpc_lanes(server, role: str = "") -> None:
    """Publish per-lane dispatch telemetry for one RpcServer: frame and
    forward counters (deltas), connection/queue-depth gauges, and a
    dispatch-wait histogram fed one window-mean sample per flush."""
    if not GlobalConfig.enable_flight_recorder or server is None:
        return
    lane_stats = getattr(server, "lane_stats", None)
    if lane_stats is None:
        return
    for snap in lane_stats():
        lane = str(snap["lane"])
        tags = {"role": role or "server", "lane": lane}
        prev = _lane_published.setdefault(
            (role, lane), {"frames": 0, "forwarded": 0, "wait_sum": 0.0,
                           "wait_count": 0},
        )
        frames = snap["frames_total"]
        forwarded = snap["forwarded_total"]
        if frames < prev["frames"]:
            # A fresh RpcServer under the same role/lane (in-process
            # init/shutdown cycle): totals restarted at zero — reset the
            # baseline so the counter stays monotonic.
            prev.update(frames=0, forwarded=0, wait_sum=0.0, wait_count=0)
        df = frames - prev["frames"]
        dfw = forwarded - prev["forwarded"]
        if df > 0:
            counter(RPC_LANE_FRAMES_TOTAL, df, tags)
        if dfw > 0:
            counter(RPC_LANE_FORWARDED_TOTAL, dfw, tags)
        gauge(RPC_LANE_CONNECTIONS, snap["connections"], tags)
        gauge(RPC_LANE_QUEUE_DEPTH, snap["inflight"], tags)
        dc = snap["dispatch_wait_count"] - prev["wait_count"]
        ds = snap["dispatch_wait_sum_s"] - prev["wait_sum"]
        if dc > 0:
            histogram(RPC_LANE_DISPATCH_WAIT_HIST, max(0.0, ds / dc), tags)
        prev["frames"] = frames
        prev["forwarded"] = forwarded
        prev["wait_sum"] = snap["dispatch_wait_sum_s"]
        prev["wait_count"] = snap["dispatch_wait_count"]


_cp_ha_published: Dict[str, float] = {}


def record_cp_ha(info: Dict) -> None:
    """Publish control-plane HA telemetry from a ``_cp_ha_info()``
    summary: role/epoch gauges, journal-append and failover counter
    deltas, and the worst standby replication lag."""
    if not GlobalConfig.enable_flight_recorder or not info:
        return
    epoch = info.get("epoch", 0)
    gauge(CP_ROLE, 1.0 if info.get("role") == "leader" else 0.0)
    gauge(CP_LEASE_EPOCH, float(epoch))
    prev_epoch = _cp_ha_published.get("epoch")
    if prev_epoch is not None and epoch > prev_epoch and prev_epoch >= 1:
        # Every epoch bump past the first election is one failover.
        counter(CP_FAILOVERS_TOTAL, float(epoch - prev_epoch))
    if epoch:
        _cp_ha_published["epoch"] = epoch
    journal = info.get("journal") or {}
    written = journal.get("records_written", 0)
    prev_written = _cp_ha_published.get("records", 0)
    if written < prev_written:
        prev_written = 0  # a fresh leader's counter restarted at zero
    if written > prev_written:
        counter(CP_JOURNAL_RECORDS_TOTAL, float(written - prev_written))
    _cp_ha_published["records"] = written
    standbys = info.get("standbys")
    if standbys is not None:
        gauge(
            CP_JOURNAL_LAG_RECORDS,
            float(max((s.get("lag_records", 0) for s in standbys),
                      default=0)),
        )


_pg_published: Dict[str, float] = {}


def record_pg_batches(stats: Dict[str, int]) -> None:
    """Publish placement-group group-commit counters (control plane)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    totals = {
        PG_COMMIT_BATCHES_TOTAL: stats.get("batches", 0),
        PG_COMMIT_BATCHED_GROUPS_TOTAL: (
            stats.get("batched_creates", 0) + stats.get("batched_removes", 0)
        ),
        PG_COMMIT_FUSED_TOTAL: stats.get("fused_commits", 0),
        PG_COMMIT_ROLLBACKS_TOTAL: stats.get("rollbacks", 0),
    }
    for name, total in totals.items():
        delta = total - _pg_published.get(name, 0)
        if delta > 0:
            _pg_published[name] = total
            counter(name, delta)


# ----------------------------------------------------------- task phases
def record_task_phases(worker, spec,
                       phases: Iterable[Tuple[str, float, float]]) -> None:
    """Record executor-side phase timings for one task: histogram samples
    (one lock round trip for the whole set) plus ``phase:<name>`` rows on
    the task-event profile channel so they render in the timeline.

    ``phases``: (name, start, end) wall-clock tuples."""
    if not GlobalConfig.enable_flight_recorder:
        return
    te = worker.task_events
    emit_rows = te is not None and GlobalConfig.enable_task_events
    task_id_hex = spec.task_id.hex() if emit_rows else ""
    entries = []
    for name, start, end in phases:
        dur = end - start
        if dur < 0:
            dur = 0.0
        entries.append((TASK_PHASE_HIST, "histogram", {"phase": name}, dur,
                        DURATION_BOUNDARIES))
        if emit_rows:
            te.add_profile_row(
                f"phase:{name}", start, end,
                {"phase": name, "task_id": task_id_hex, "task": spec.name},
            )
    _metrics._record_batch(entries)


def record_backpressure_wait(duration_s: float) -> None:
    """One submission blocked on the task-queue memory cap for
    ``duration_s`` (called from the blocked user thread, after the wait)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    _metrics._record_batch([
        (BACKPRESSURE_WAIT_HIST, "histogram", {}, float(duration_s),
         DURATION_BOUNDARIES),
        (BACKPRESSURE_BLOCKED_TOTAL, "counter", {}, 1.0, None),
    ])
    # Phase row so backpressure stalls render on the timeline next to the
    # task phases they delayed.
    from ..core.core_worker import try_global_worker

    w = try_global_worker()
    te = w.task_events if w is not None else None
    if te is not None and GlobalConfig.enable_task_events:
        now = time.time()
        te.add_profile_row(
            "phase:backpressure_wait", now - duration_s, now,
            {"phase": "backpressure_wait"},
        )


# ------------------------------------------------------------ collectives
_COLLECTIVE_OPS = (
    "allreduce", "allgather", "reducescatter", "broadcast", "alltoall",
    "ppermute", "sendrecv_ring",
)


def _payload_nbytes(tensor) -> int:
    """Bytes in one op's input: a tensor, or a per-rank list of tensors."""
    if isinstance(tensor, (list, tuple)):
        return sum(_payload_nbytes(t) for t in tensor)
    n = getattr(tensor, "nbytes", None)
    if n is not None:
        return int(n)
    try:
        import numpy as np

        return int(np.asarray(tensor).nbytes)
    except Exception:  # noqa: BLE001 — telemetry must never fail an op
        return 0


def record_collective(op: str, backend: str, nbytes: int, world_size: int,
                      duration_s: float, cold: bool = False,
                      algo: str = "", group: str = "",
                      wire_bytes: Optional[int] = None) -> None:
    if not GlobalConfig.enable_flight_recorder:
        return
    if duration_s <= 0:
        duration_s = 1e-9
    op_tags = {"op": op, "backend": backend}
    if group:
        op_tags["group"] = group
    hist_tags = {"op": op, "world_size": str(world_size)}
    if algo:
        hist_tags["algo"] = algo
    if cold:
        # First call of an (op, shape, dtype): the duration carries jax
        # trace+compile, not collective transfer — tagged so scrapers (and
        # local_collective_stats) can exclude it from bandwidth math.
        hist_tags["cold"] = "1"
    entries = [
        (COLLECTIVE_OPS_TOTAL, "counter", op_tags, 1.0, None),
        (COLLECTIVE_BYTES_TOTAL, "counter", op_tags, float(nbytes), None),
        (COLLECTIVE_DURATION_HIST, "histogram", hist_tags, duration_s,
         DURATION_BOUNDARIES),
        (COLLECTIVE_BANDWIDTH_HIST, "histogram", hist_tags,
         nbytes / duration_s, BANDWIDTH_BOUNDARIES),
    ]
    if wire_bytes is not None and wire_bytes < nbytes:
        # Block-quantized exchange: account the wire-byte reduction.
        entries.append((COLLECTIVE_QUANTIZED_OPS_TOTAL, "counter",
                        {"op": op}, 1.0, None))
        entries.append((COLLECTIVE_QUANTIZED_BYTES_SAVED_TOTAL, "counter",
                        {"op": op}, float(nbytes - wire_bytes), None))
    _metrics._record_batch(entries)


def _payload_dtype(tensor):
    """dtype of one op's input (first leaf of a per-rank list)."""
    if isinstance(tensor, (list, tuple)):
        return _payload_dtype(tensor[0]) if tensor else "float32"
    return getattr(tensor, "dtype", "float32")


def _shape_sig(tensor) -> tuple:
    if isinstance(tensor, (list, tuple)):
        return (len(tensor),) + (
            _shape_sig(tensor[0]) if tensor else ()
        )
    return (
        tuple(getattr(tensor, "shape", ())), str(getattr(tensor, "dtype", ""))
    )


def _sync_cuda_outputs(out) -> None:
    """Wait until every CUDA tensor in ``out`` is computed: synchronize
    the current stream of each card they lie on (the port's
    ``jax.block_until_ready``)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:  # no tensor exists in a process without torch
        return
    from torch.utils import _pytree as pytree

    devices = {
        leaf.device for leaf in pytree.tree_leaves(out)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for device in devices:
        torch.cuda.current_stream(device).synchronize()


def _wrap_collective_op(fn, op: str, backend: str, group, seen_keys: set):
    import functools

    @functools.wraps(fn)
    def wrapped(tensor, *args, **kwargs):
        if not GlobalConfig.enable_flight_recorder:
            return fn(tensor, *args, **kwargs)
        # Mirrors the groups' compiled-fn cache keying (op + shape +
        # dtype): the first call of a key pays trace+compile and is
        # tagged cold.  The ALGORITHM is part of the executable too, so a
        # tuner exploration that switches algorithms is its own cold key.
        # Ops outside the selection layer (broadcast/alltoall/permute)
        # never write _last_decision — clear it so they can't inherit
        # the previous op's algorithm/bucket attribution.
        group._last_decision = None
        key = (op, _shape_sig(tensor))
        t_wall = time.time()
        t0 = time.perf_counter()
        out = fn(tensor, *args, **kwargs)
        if getattr(group, "_last_decision", None) is not None:
            # The op went through algorithm selection: the autotuner's
            # feedback must be device-complete time, not async dispatch
            # (CUDA kernels return before they finish — timing dispatch
            # would make the commit argmax a coin flip).  Host outputs
            # need no wait.
            _sync_cuda_outputs(out)
        dt = time.perf_counter() - t0
        decision = getattr(group, "_last_decision", None)
        if decision is not None:
            key = key + (decision["algo"],)
        cold = key not in seen_keys
        seen_keys.add(key)
        nbytes = _payload_nbytes(tensor)
        world = getattr(group, "world_size", 0) or 1
        wire = None
        if decision is not None and decision["algo"].endswith("_q8"):
            # Keyed on the EXECUTED algorithm, not the request: a
            # quantized=True call that lowered to plain flat (e.g.
            # world_size 1) exchanged exact bytes and saved nothing.
            from ..collective import algorithms as _alg

            wire = _alg.quantized_wire_bytes(
                nbytes, _payload_dtype(tensor),
                GlobalConfig.collective_quant_block_size,
            )
        record_collective(
            op, backend, nbytes, world, dt, cold=cold,
            algo=decision["algo"] if decision else "",
            group=getattr(group, "group_name", ""),
            wire_bytes=wire,
        )
        # Stitch into an active trace: a collective inside a traced task
        # records a span tagged with the tuner's chosen algorithm, so a
        # cluster trace shows which algorithm each hop committed to.
        from . import tracing as _tracing

        if _tracing.current_context() is not None:
            _tracing.record_span(
                f"collective:{op}", t_wall, t_wall + dt,
                {
                    "op": op, "backend": backend, "bytes": nbytes,
                    "world_size": world,
                    "algo": decision["algo"] if decision else "",
                    "cold": cold,
                },
            )
        if decision is not None:
            # Close the loop: the achieved-bandwidth sample drives the
            # online autotuner's next selection for this bucket.
            from ..collective.tuner import get_tuner

            get_tuner().observe(
                op, decision["nbytes"], decision["world_size"],
                getattr(group, "topology", None), decision["algo"],
                nbytes / max(dt, 1e-9), cold=cold,
            )
        return out

    wrapped._fr_wrapped = True
    return wrapped


def instrument_group(group, backend: str):
    """Wrap a collective group's ops with op/bytes/world-size/duration
    capture (called from the group constructors).  Timing covers dispatch
    plus whatever host sync the op itself performs — the multi-host XLA
    backend materializes results to numpy, so its numbers reflect the real
    collective; a purely async local dispatch reads as dispatch cost (see
    docs/observability.md).  Always wraps (the per-call gate handles a
    disabled recorder, so flipping the knob mid-lifetime works) and is
    idempotent."""
    seen_keys: set = set()
    for op in _COLLECTIVE_OPS:
        orig = getattr(group, op, None)
        if orig is None or getattr(orig, "_fr_wrapped", False):
            continue
        setattr(group, op,
                _wrap_collective_op(orig, op, backend, group, seen_keys))
    return group


# ----------------------------------------------------- pipeline trainer
def record_pipeline_op(kind: str, stage: int, duration_s: float) -> None:
    """One pipeline-stage op (``"F"``/``"B"``) of ``duration_s`` on
    ``stage`` — stage actors call this per microbatch op."""
    if not GlobalConfig.enable_flight_recorder:
        return
    name = PIPELINE_STAGE_FWD_HIST if kind == "F" else PIPELINE_STAGE_BWD_HIST
    histogram(name, duration_s, {"stage": str(stage)})


def record_pipeline_step(stage: int, stall_s: float, wall_s: float,
                         microbatches: int) -> None:
    """End-of-step accounting on a stage actor: total neighbor-wait time,
    step wall, and per-stage bubble (stall/wall)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    tags = {"stage": str(stage)}
    _metrics._record_batch([
        (PIPELINE_STAGE_STALL_HIST, "histogram", tags, float(stall_s),
         DURATION_BOUNDARIES),
        (PIPELINE_MICROBATCHES_TOTAL, "counter", tags, float(microbatches),
         None),
        (PIPELINE_BUBBLE_FRACTION, "gauge", tags,
         float(stall_s / wall_s) if wall_s > 0 else 0.0, None),
    ])


def record_pipeline_transfer(nbytes: int, duration_s: float) -> None:
    """One acknowledged inter-stage push (activation or gradient)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    _metrics._record_batch([
        (PIPELINE_ACTIVATION_BYTES_TOTAL, "counter", {}, float(nbytes), None),
        (PIPELINE_ACTIVATION_BANDWIDTH_HIST, "histogram", {},
         nbytes / max(duration_s, 1e-9), BANDWIDTH_BOUNDARIES),
    ])


def record_pipeline_bubble(overall: float, per_stage=None) -> None:
    """Driver-side computed bubble fraction for one step (gauge)."""
    gauge(PIPELINE_BUBBLE_FRACTION, overall, {"stage": "all"})
    for stage, frac in (per_stage or {}).items():
        gauge(PIPELINE_BUBBLE_FRACTION, frac, {"stage": str(stage)})


def record_pipeline_restart(stage: int) -> None:
    counter(PIPELINE_STAGE_RESTARTS_TOTAL, 1.0, {"stage": str(stage)})


# ------------------------------------------------------- podracer RL
# Staleness is measured in learner versions (small ints), not seconds.
STALENESS_BOUNDARIES = [0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]


def record_rl_rollout(arch: str, env_steps: int, duration_s: float,
                      devices: int = 0) -> None:
    """One measured rollout window for an RL trainer: transitions
    produced and the achieved env-step throughput gauge."""
    if not GlobalConfig.enable_flight_recorder:
        return
    tags = {"arch": arch}
    if devices:
        tags["devices"] = str(devices)
    _metrics._record_batch([
        (RL_ENV_STEPS_TOTAL, "counter", tags, float(env_steps), None),
        (RL_ENV_STEPS_PER_S, "gauge", tags,
         env_steps / max(duration_s, 1e-9), None),
    ])


def record_rl_update(arch: str, staleness: Optional[int] = None,
                     queue_depth: Optional[int] = None, n: int = 1) -> None:
    """``n`` learner gradient updates (Anakin applies a whole scanned
    chunk per call); ``staleness`` is how many learner versions behind
    the consumed trajectory's behavior policy was."""
    if not GlobalConfig.enable_flight_recorder:
        return
    tags = {"arch": arch}
    rows = [(RL_LEARNER_UPDATES_TOTAL, "counter", tags, float(n), None)]
    if staleness is not None:
        rows.append((RL_PARAM_STALENESS_HIST, "histogram", tags,
                     float(staleness), STALENESS_BOUNDARIES))
    if queue_depth is not None:
        rows.append((RL_TRAJ_QUEUE_DEPTH, "gauge", tags,
                     float(queue_depth), None))
    _metrics._record_batch(rows)


def record_rl_learner_rate(arch: str, updates_per_s: float) -> None:
    gauge(RL_LEARNER_STEPS_PER_S, updates_per_s, {"arch": arch})


def record_rl_broadcast(nbytes: int, fanout: int) -> None:
    """One parameter broadcast: payload serialized once, pushed to
    ``fanout`` runners (wire bytes = nbytes * remote fan-out)."""
    counter(RL_PARAM_BROADCAST_BYTES_TOTAL, float(nbytes) * max(fanout, 1))


def record_rl_stale_dropped(arch: str, n: int = 1) -> None:
    counter(RL_STALE_TRAJS_DROPPED_TOTAL, float(n), {"arch": arch})


def record_rl_runner_restart(group: str) -> None:
    counter(RL_RUNNER_RESTARTS_TOTAL, 1.0, {"group": group})


# --------------------------------------------------- per-request serving
def record_serve_request(deployment: str, replica: str, queue_wait_s: float,
                         ttft_s: float, outcome: str = "ok",
                         streaming: bool = False) -> None:
    """One completed serving request on a replica: queue wait (arrival →
    user-concurrency slot) and time-to-first-result (the full latency for
    unary requests, the first chunk for streams).  These are the signals
    the continuous-batching serving gate (ROADMAP item 5) reports on."""
    if not GlobalConfig.enable_flight_recorder:
        return
    tags = {"deployment": deployment, "replica": replica}
    _metrics._record_batch([
        (SERVE_QUEUE_WAIT_HIST, "histogram", tags, max(0.0, queue_wait_s),
         DURATION_BOUNDARIES),
        (SERVE_TTFT_HIST, "histogram", tags, max(0.0, ttft_s),
         DURATION_BOUNDARIES),
        (SERVE_REQUESTS_TOTAL, "counter",
         {"deployment": deployment, "outcome": outcome,
          "streaming": "1" if streaming else "0"}, 1.0, None),
    ])


def record_serve_stream(deployment: str, replica: str, queue_wait_s: float,
                        ttft_s: float, gaps, outcome: str = "ok") -> None:
    """One completed streaming request: TTFT plus every inter-chunk gap
    (the inter-token stall distribution), recorded in ONE registry round
    trip at stream end so the per-token path stays an append."""
    if not GlobalConfig.enable_flight_recorder:
        return
    tags = {"deployment": deployment, "replica": replica}
    entries = [
        (SERVE_QUEUE_WAIT_HIST, "histogram", tags, max(0.0, queue_wait_s),
         DURATION_BOUNDARIES),
        (SERVE_TTFT_HIST, "histogram", tags, max(0.0, ttft_s),
         DURATION_BOUNDARIES),
        (SERVE_REQUESTS_TOTAL, "counter",
         {"deployment": deployment, "outcome": outcome, "streaming": "1"},
         1.0, None),
    ]
    entries.extend(
        (SERVE_INTER_TOKEN_HIST, "histogram", tags, max(0.0, g),
         DURATION_BOUNDARIES)
        for g in gaps
    )
    _metrics._record_batch(entries)


class StreamTelemetry:
    """Per-stream accumulator for the serving hot path: ``tick()`` per
    chunk is two float ops + an append; everything else happens once at
    ``done()``."""

    __slots__ = ("deployment", "replica", "queue_wait_s", "_t0", "_last",
                 "gaps", "ttft_s")

    def __init__(self, deployment: str, replica: str,
                 queue_wait_s: float = 0.0):
        self.deployment = deployment
        self.replica = replica
        self.queue_wait_s = queue_wait_s
        self._t0 = time.perf_counter()
        self._last: Optional[float] = None
        self.gaps: list = []
        self.ttft_s: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is None:
            self.ttft_s = now - self._t0
        else:
            self.gaps.append(now - self._last)
        self._last = now

    def done(self, outcome: str = "ok") -> None:
        record_serve_stream(
            self.deployment, self.replica, self.queue_wait_s,
            self.ttft_s if self.ttft_s is not None else
            time.perf_counter() - self._t0,
            self.gaps, outcome=outcome,
        )


def record_serve_autoscale(deployment: str, direction: str,
                           replicas: int) -> None:
    """One autoscale decision on the serve controller: ``direction`` is
    up / down / drain_retired / drain_forced; ``replicas`` is the new
    total (routable + draining) for the deployment gauge."""
    if not GlobalConfig.enable_flight_recorder:
        return
    _metrics._record_batch([
        (SERVE_AUTOSCALE_EVENTS_TOTAL, "counter",
         {"deployment": deployment, "direction": direction}, 1.0, None),
        (SERVE_REPLICAS, "gauge", {"deployment": deployment},
         float(replicas), None),
    ])


def record_mux_cache_event(event: str) -> None:
    """One multiplexed-model cache event on a replica (hit / miss /
    eviction)."""
    counter(SERVE_MUX_CACHE_EVENTS_TOTAL, 1.0, {"event": event})


# ------------------------------------------------ multi-tenant arbitration
def record_sched_event(kind: str, **tags) -> None:
    """One arbitration decision on the control plane.  ``kind``:
    ``preemption`` (budget spent, victims selected — tag ``victims``),
    ``preemption_victim`` (one group checkpoint-then-evicted — tags
    ``pg``/``priority``/``acks``), ``preemption_denied`` (token bucket
    empty or quarantined), ``admission_queued`` (over-quota request
    parked, not failed)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    if kind == "preemption":
        counter(SCHED_PREEMPTIONS_TOTAL, 1.0,
                {"job": str(tags.get("job", ""))})
    elif kind == "preemption_victim":
        counter(SCHED_PREEMPTION_VICTIMS_TOTAL, 1.0,
                {"priority": str(tags.get("priority", ""))})
    elif kind == "preemption_denied":
        counter(SCHED_PREEMPTIONS_DENIED_TOTAL, 1.0,
                {"job": str(tags.get("job", ""))})
    elif kind == "admission_queued":
        counter(SCHED_ADMISSION_QUEUED_TOTAL, 1.0,
                {"job": str(tags.get("job", ""))})


# ------------------------------------------------------- elastic capacity
def record_autoscaler_launch(node_type: str, outcome: str) -> None:
    """One launch attempt in an autoscaler round.  ``outcome``: ``ok``,
    ``error`` (provider raised), ``backoff`` (gated by the per-type
    launch backoff, no provider call made)."""
    counter(AUTOSCALER_LAUNCHES_TOTAL, 1.0,
            {"type": node_type, "outcome": outcome})


def record_autoscaler_termination(outcome: str) -> None:
    """One provider terminate.  ``outcome``: ``drained`` (clean drain),
    ``timeout`` (drain deadline expired, terminated anyway), ``direct``
    (drain disabled), ``reclaimed`` (provider record for a node the
    control plane declared dead), ``error``."""
    counter(AUTOSCALER_TERMINATIONS_TOTAL, 1.0, {"outcome": outcome})


def record_autoscaler_drain(outcome: str,
                            duration_s: Optional[float] = None) -> None:
    """Drain state-machine transitions (``started`` / ``drained`` /
    ``timeout`` / ``cancelled``); resolved drains also record the
    mark-to-terminate wall time."""
    counter(AUTOSCALER_DRAINS_TOTAL, 1.0, {"outcome": outcome})
    if duration_s is not None:
        histogram(AUTOSCALER_DRAIN_DURATION_HIST, duration_s)


def record_autoscaler_pending_demand(count: int) -> None:
    gauge(AUTOSCALER_PENDING_DEMAND, float(count))


def record_elastic_resize(direction: str) -> None:
    """One elastic-trainer world-size crossover (``grow`` / ``shrink``)."""
    counter(TRAIN_ELASTIC_RESIZES_TOTAL, 1.0, {"direction": direction})


# ------------------------------------------ continuous-batching LLM serving
def record_llm_step(occupancy: int, queue_depth: int, admitted: int,
                    retired: int, bucket: int) -> None:
    """One token boundary + decode step of the continuous-batching
    scheduler: batch occupancy / bucket / queue-depth gauges plus the
    per-step admission/retirement counters (docs/llm_serving.md)."""
    if not GlobalConfig.enable_flight_recorder:
        return
    entries = [
        (LLM_BATCH_OCCUPANCY, "gauge", {}, float(occupancy), None),
        (LLM_BATCH_BUCKET, "gauge", {}, float(bucket), None),
        (LLM_QUEUE_DEPTH, "gauge", {}, float(queue_depth), None),
        (LLM_DECODE_STEPS_TOTAL, "counter", {}, 1.0, None),
    ]
    if admitted:
        entries.append((LLM_ADMITTED_TOTAL, "counter", {}, float(admitted),
                        None))
    if retired:
        entries.append((LLM_RETIRED_TOTAL, "counter", {}, float(retired),
                        None))
    _metrics._record_batch(entries)


def record_llm_preemption() -> None:
    counter(LLM_PREEMPTIONS_TOTAL, 1.0)


def record_llm_prefix_lookup(site: str, hit: bool, n: int = 1) -> None:
    """Prefix-KV cache accounting, by lookup site (``engine`` = full-
    coverage admission reuse on a decode replica, ``router`` = affinity
    decisions on the request router)."""
    counter(
        LLM_PREFIX_CACHE_HITS_TOTAL if hit else LLM_PREFIX_CACHE_MISSES_TOTAL,
        float(n), {"site": site},
    )


def record_slo_violation(rule: str) -> None:
    counter(SLO_VIOLATIONS_TOTAL, 1.0, {"rule": rule})


def record_remediation_action(rule: str, action: str, outcome: str) -> None:
    """One remediation-controller decision: what rule fired, which
    actuator was chosen, and what actually happened to it."""
    counter(REMEDIATION_ACTIONS_TOTAL, 1.0,
            {"rule": rule, "action": action, "outcome": outcome})


def record_remediation_quarantine(count: int) -> None:
    """Gauge of currently-quarantined remediation targets (updated on
    every controller beat; nonzero means the reflex arc stopped itself
    and a human should look)."""
    gauge(REMEDIATION_QUARANTINED, float(count))


# -------------------------------------------------------- scaling gauge
def record_scaling_efficiency(devices: int, retention: float) -> None:
    """ICI scaling-efficiency gauge, fed by scaling_bench's calibrated
    partition-retention ratio (1.0 = partitioning machinery is free)."""
    gauge(ICI_SCALING_EFFICIENCY, retention, {"devices": str(devices)})


def local_collective_stats() -> Dict[str, dict]:
    """This process's per-op collective aggregates (ops, bytes, mean
    duration) from the local registry — no cluster round trip."""
    _COLLECTIVE_METRICS = (
        COLLECTIVE_OPS_TOTAL, COLLECTIVE_BYTES_TOTAL, COLLECTIVE_DURATION_HIST,
    )
    out: Dict[str, dict] = {}
    with _metrics._lock:
        for (name, tags), ent in _metrics._local.items():
            if name not in _COLLECTIVE_METRICS:
                continue  # user metrics may carry an "op" tag too
            op = dict(tags).get("op")
            if op is None:
                continue
            row = out.setdefault(op, {"ops": 0, "bytes": 0.0,
                                      "duration_sum_s": 0.0, "samples": 0})
            if name == COLLECTIVE_OPS_TOTAL:
                row["ops"] += int(ent["value"])
            elif name == COLLECTIVE_BYTES_TOTAL:
                row["bytes"] += ent["value"]
            elif dict(tags).get("cold") != "1":
                # Warm samples only: cold ones time jax trace+compile.
                row["duration_sum_s"] += ent["sum"]
                row["samples"] += ent["count"]
    for row in out.values():
        row["mean_duration_s"] = (
            row["duration_sum_s"] / row["samples"] if row["samples"] else 0.0
        )
    return out


def cluster_collective_stats() -> Dict[str, dict]:
    """Cluster-aggregated collective view: every worker's collective
    counters merged through the cluster observability plane
    (``ray_tpu_torch.util.obs`` — workers flush their local registries to the
    control-plane KV, the node agent forwards them on its heartbeat),
    so the autotuner's decisions are observable from the driver.

    Returns ``{"ops": {op: {...}}, "groups": {group: {op: {...}}},
    "algorithms": {op: {algo: {bucket: ops}}}}`` — ops/bytes summed
    across workers, per-group rows keyed by the group tag recorded with
    each op, and the per-bucket algorithm-decision counters.  Kept as a
    thin API-compatible wrapper; the merge itself lives once, in
    ``obs.collective_view``."""
    from . import obs as _obs

    return _obs.collective_view()
