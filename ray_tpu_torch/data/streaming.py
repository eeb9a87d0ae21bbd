"""Streaming data-plane scheduler: an operator-graph executor.

Replaces the iterator-chained executor (each stage a generator pulling its
upstream, every block funneled through head-of-line ``popleft``) with a
real scheduler over operator NODES connected by bounded input/output
queues (reference: ray ``python/ray/data/_internal/execution/
streaming_executor_state.py`` — topology + ``select_operator_to_run``;
Podracer's producer/consumer decoupling is the design argument: deep
asynchronous pipelines keep accelerators fed).

Three capabilities over the old chain:

  - **out-of-order streaming** — completions are harvested with
    ``ray_tpu_torch.wait(..., num_returns=1)`` over the whole in-flight set, so
    one straggler map task no longer blocks finished downstream work.
    Ordered emission stays the DEFAULT (``iter_batches`` determinism);
    unordered is opt-in via ``ExecutionOptions(preserve_order=False)``,
    which emits each block the moment its task finishes.
  - **operator autoscaling** — ``ActorPoolStrategy(min_size, max_size)``
    pools grow on sustained input-queue pressure, shrink (idle actors are
    killed) on starvation, and dispatch least-loaded instead of blind
    round-robin.
  - **dynamic block shaping** — map outputs larger than
    ``target_block_size_bytes`` are split and undersized runs coalesced
    before the next exchange, bounding per-task memory and shuffle fan-in
    skew (reference: ray's dynamic block splitting /
    ``OutputBlockSizeOption``).

The scheduler also owns **early-exit cancellation**: when a consumer stops
pulling (``take(n)`` satisfied, ``limit`` reached, or the iterator is
abandoned), every still-in-flight upstream task ref is ``ray_tpu_torch.cancel``ed
and actor pools are torn down instead of running to completion.

Everything is driven from the consuming thread — one ``_step`` pass feeds
sources, launches under the ``ResourceManager`` budget, harvests
completions, and autoscales; blocking waits are bounded slices
(``data_straggler_wait_slice_s``) and recorded as straggler time.  The
scheduler self-instruments via the flight recorder: queue depths,
straggler waits, autoscale events, split/coalesce counts.
"""

from __future__ import annotations

import logging
import math
import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import ray_tpu_torch

from ..core.config import GlobalConfig
from ..util import flight_recorder as fr
# Module-level reference (not from-imports) for the accounting class:
# tests monkeypatch ``backpressure.OpResourceState`` to observe launches.
from . import backpressure as _bp
from .backpressure import (
    ResourceManager,
    can_launch,
    default_policies,
    ref_size_if_known,
)
from .block import concat_columnar
from .execution import (
    LimitStage,
    MapStage,
    OpStats,
    _MapWorker,
    _run_item,
)

logger = logging.getLogger(__name__)

# Cap on how many pieces one oversized block splits into: a grossly
# mis-sized block (or tiny target) must not explode into thousands of
# near-empty objects.
_MAX_SPLIT_FANOUT = 64

# Limit-node row counting is hybrid.  At or under this size the block is
# fetched with a driver-side get: served from shm, cheaper than a remote
# counting task that queues behind in-flight upstream work on busy
# workers (measured: seconds of lease/pipeline wait on a saturated
# node), and it warms the driver's object cache for the consumer, which
# fetches this very block next.  Above it, a remote count/trim task runs
# next to the data instead — the limit must never haul hundreds of MB
# over the wire just to learn a row count.
_LIMIT_DRIVER_FETCH_MAX_BYTES = 4 << 20


def _op_label(name: str) -> str:
    """Metric-label form of an operator name: the base name only.

    Stage names embed user content — ``Filter[('v', '>=', 10)]``,
    ``Limit[5]`` — which is both unbounded label cardinality and full of
    characters (quotes, commas) that strict exposition parsers reject
    inside label values.  ``Filter[...]`` → ``Filter``."""
    m = re.match(r"\w+", name)
    return m.group(0) if m else "op"

# Data block tasks are coarse-grained (10s-100s of ms): push them depth-1
# per worker.  Under the default deep pipelining
# (max_tasks_in_flight_per_worker) a straggler pushed ahead of fast tasks
# on a shared worker serializes them at the worker's exec pipeline —
# worker-level head-of-line blocking that no amount of out-of-order
# completion harvesting can undo.
_run_block = _run_item.options(pipeline_depth=1)


def _run_block_ref(item):
    return _run_block.remote(item, [])


def _try_cancel(refs, stats: Optional[OpStats] = None) -> None:
    """Best-effort early-exit cancel that tolerates a torn-down runtime.

    Abandoned iterators are cancelled from generator ``close()``, which
    can run at GC time AFTER ``ray_tpu_torch.shutdown()`` — ``global_worker()``
    then raises, and an exception escaping ``close()`` turns into
    "Exception ignored in" noise (or propagates to an explicit closer).
    Cancelling an already-completed ref is a documented no-op, so callers
    pass whole queues without filtering."""
    if not refs:
        return
    try:
        ray_tpu_torch.cancel(list(refs))
    except Exception as e:  # noqa: BLE001 — teardown must not raise
        logger.debug("early-exit cancel skipped: %s", e)
        return
    if stats is not None:
        # Requests, not kills: cancel is best-effort and an
        # already-executing task runs to completion.
        stats.tasks_cancel_requested += len(refs)


@dataclass
class ExecutionOptions:
    """Per-plan execution knobs (reference: ray ``ExecutionOptions``).

    ``preserve_order=True`` (default) keeps block emission in plan order —
    ``take``/``iter_batches`` stay deterministic.  ``False`` opts into
    out-of-order streaming: blocks flow downstream the moment their task
    completes, so a straggler never head-of-line-blocks the pipeline.

    ``target_block_size_bytes`` overrides the
    ``data_target_block_size_bytes`` config knob for this plan; ``None``
    defers to the knob, ``0`` disables dynamic block shaping.
    """

    preserve_order: bool = True
    target_block_size_bytes: Optional[int] = None

    def resolved_target_block_bytes(self) -> int:
        if self.target_block_size_bytes is None:
            return GlobalConfig.data_target_block_size_bytes
        return int(self.target_block_size_bytes)


# ---------------------------------------------------------- block shaping
@ray_tpu_torch.remote
def _split_block(block, k: int):
    """Split one block into k contiguous row ranges (num_returns=k fans
    the list into one object per part).  Row-exact: concatenating the
    parts in order reproduces the input."""
    n = len(block)
    bounds = [round(i * n / k) for i in range(k + 1)]
    parts = [block[bounds[i]:bounds[i + 1]] for i in range(k)]
    return parts if k > 1 else parts[0]


@ray_tpu_torch.remote
def _count_rows(block) -> int:
    return len(block)


@ray_tpu_torch.remote
def _trim_block(block, n: int):
    return block[:n]


@ray_tpu_torch.remote
def _coalesce_blocks(*parts):
    """Concatenate small blocks into one (columnar stays columnar)."""
    cat = concat_columnar(parts)
    if cat is not None:
        return cat
    rows: list = []
    for p in parts:
        rows.extend(p)
    return rows


# ---------------------------------------------------------------- op nodes
class _OpNode:
    """One operator in the topology: a bounded input queue, an output
    queue, and (for task-running nodes) an in-flight set the scheduler
    harvests completions from."""

    def __init__(self, name: str, stats: Optional[OpStats]):
        self.name = name
        self.op_label = _op_label(name)
        self.stats = stats
        self.input: deque = deque()  # (item, enqueue_ts)
        self.out: deque = deque()
        self.input_done = False
        self.finished = False
        self._t0: Optional[float] = None
        self._input_bound = max(
            2, GlobalConfig.data_max_tasks_per_op * 2
        )
        self._out_bound = max(1, GlobalConfig.data_output_queue_depth)
        self._last_gauge = 0.0

    # -- queue plumbing (called by the scheduler) -------------------------
    def can_accept(self) -> bool:
        return len(self.input) < self._input_bound

    def add_input(self, item) -> None:
        self.input.append((item, time.perf_counter()))

    def mark_input_done(self) -> None:
        self.input_done = True

    @property
    def done(self) -> bool:
        return self.finished and not self.out

    # -- scheduling hooks --------------------------------------------------
    def inflight_refs(self):
        return ()

    def on_ready(self, ref) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def step(self, sched: "StreamingScheduler") -> bool:
        raise NotImplementedError

    def cancel_remaining(self, sched: "StreamingScheduler") -> None:
        """Early exit: drop queued work, cancel in-flight tasks, finish.

        Queued input items and buffered output refs may themselves be
        still-pending upstream tasks (a barrier emits reduce refs before
        they finish, a shape node emits split/coalesce refs at launch) —
        cancel them too; completed refs make it a no-op."""
        _try_cancel(
            [item for item, _enq in self.input
             if isinstance(item, ray_tpu_torch.ObjectRef)]
            + [r for r in self.out if isinstance(r, ray_tpu_torch.ObjectRef)]
        )
        self.input.clear()
        self.out.clear()
        self.input_done = True
        self._finish()

    # -- shared helpers ----------------------------------------------------
    def _emit(self, ref) -> None:
        self.out.append(ref)
        if self.stats is not None:
            self.stats.blocks_emitted += 1

    def _mark_started(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def _finish(self) -> None:
        if self.finished:
            return
        self.finished = True
        if self.stats is not None:
            if self._t0 is not None:
                self.stats.wall_s = time.perf_counter() - self._t0
            fr.counter(
                fr.DATA_BLOCKS_EMITTED_TOTAL,
                float(self.stats.blocks_emitted),
                {"op": self.op_label},
            )

    def _gauge_queues(self) -> None:
        now = time.perf_counter()
        if now - self._last_gauge < GlobalConfig.data_autoscale_interval_s:
            return
        self._last_gauge = now
        fr.gauge(fr.DATA_QUEUE_DEPTH, float(len(self.input)),
                 {"op": self.op_label})


class _MapTaskNode(_OpNode):
    """Fused narrow transforms on task compute, with out-of-order
    completion harvesting and ordered/unordered emission."""

    def __init__(self, stage: MapStage, options: ExecutionOptions,
                 rm: Optional[ResourceManager], stats_list: List[OpStats]):
        st = OpStats(stage.name)
        stats_list.append(st)
        super().__init__(stage.name, st)
        self.transforms = list(stage.transforms)
        self.ordered = options.preserve_order
        self.policies = (
            rm.policies_for_op() if rm is not None else default_policies()
        )
        self.op_state = _bp.OpResourceState(stage.name)
        self._inflight: Dict[Any, int] = {}  # ref -> launch seq
        self._completed: Dict[int, Any] = {}  # ordered-mode reorder buffer
        self._launch_seq = 0
        self._emit_seq = 0

    def _buffered_out(self) -> int:
        return len(self.out) + len(self._completed)

    def inflight_refs(self):
        return self._inflight.keys()

    def step(self, sched) -> bool:
        if self.finished:
            return False
        progress = False
        while (
            self.input
            and self._buffered_out() < self._out_bound
            and can_launch(self.op_state, self.policies)
        ):
            item, enq = self.input.popleft()
            self._mark_started()
            self.stats.add_queue_wait(time.perf_counter() - enq)
            ref = _run_block.remote(item, self.transforms)
            self._inflight[ref] = self._launch_seq
            self._launch_seq += 1
            self.op_state.on_launch()
            self.stats.num_tasks += 1
            progress = True
        self._gauge_queues()
        return self._maybe_finish() or progress

    def on_ready(self, ref) -> None:
        seq = self._inflight.pop(ref, None)
        if seq is None:
            return
        self.op_state.on_output_consumed(ref_size_if_known(ref))
        if self.ordered:
            self._completed[seq] = ref
            while self._emit_seq in self._completed:
                self._emit(self._completed.pop(self._emit_seq))
                self._emit_seq += 1
        else:
            self._emit(ref)
        self._maybe_finish()

    def _maybe_finish(self) -> bool:
        if (
            not self.finished
            and self.input_done
            and not self.input
            and not self._inflight
            and not self._completed
        ):
            self._finish()
            return True
        return False

    def cancel_remaining(self, sched) -> None:
        _try_cancel(list(self._inflight), self.stats)
        self._inflight.clear()
        self._completed.clear()
        super().cancel_remaining(sched)


class _PoolActor:
    __slots__ = ("handle", "inflight", "idle_since")

    def __init__(self, handle):
        self.handle = handle
        self.inflight = 0
        self.idle_since = time.perf_counter()


class _ActorPoolNode(_OpNode):
    """Stateful map on an autoscaling actor pool: least-loaded dispatch,
    scale-up on sustained input-queue pressure, scale-down (kill idle
    actors) on starvation."""

    def __init__(self, stage: MapStage, options: ExecutionOptions,
                 stats_list: List[OpStats]):
        st = OpStats(stage.name)
        stats_list.append(st)
        super().__init__(stage.name, st)
        strat = stage.compute
        self.transforms = list(stage.transforms)
        self.ordered = options.preserve_order
        self.min_size = strat.min_size
        self.max_size = strat.max_size
        self.max_in_flight = strat.max_tasks_in_flight_per_actor
        self._worker_cls = ray_tpu_torch.remote(_MapWorker).options(
            num_cpus=strat.num_cpus if strat.num_cpus is not None else 1,
            num_gpus=strat.num_gpus or None,
        )
        self._actors: List[_PoolActor] = []
        self._inflight: Dict[Any, tuple] = {}  # ref -> (seq, _PoolActor)
        self._completed: Dict[int, Any] = {}
        self._launch_seq = 0
        self._emit_seq = 0
        self._last_autoscale = 0.0
        self._pressure_streak = 0
        self._force_scale_up = False
        self._input_bound = max(
            self._input_bound, self.max_size * self.max_in_flight * 2
        )
        for _ in range(self.min_size):
            self._spawn_actor()
        self._record_pool_size()
        # SLO remediation hook: while this pool runs, a sustained
        # queue_pressure finding on its op can force one scale-up
        # (outside the two-streak hysteresis; still bounded by max_size).
        from ray_tpu_torch.util import remediation as _remediation

        self._remediation_handle = _remediation.register_actuator(
            "data_pool_scale_up", self._remediation_scale_up,
            target=self.op_label,
        )

    def _remediation_scale_up(self, target: str, violation, **_kw) -> str:
        from ray_tpu_torch.util.remediation import RemediationSkipped

        if self.finished:
            raise RemediationSkipped("pool already finished")
        if len(self._actors) >= self.max_size:
            raise RemediationSkipped(f"at max_size={self.max_size}")
        self._force_scale_up = True  # applied by the scheduler thread
        return f"pool {self.op_label}: scale-up forced"

    # -- pool management ---------------------------------------------------
    def _spawn_actor(self) -> None:
        self._actors.append(_PoolActor(self._worker_cls.remote(self.transforms)))

    def _kill_actor(self, entry: _PoolActor) -> None:
        self._actors.remove(entry)
        try:
            ray_tpu_torch.kill(entry.handle)
        except Exception as e:  # noqa: BLE001 — teardown must not raise
            logger.debug("actor-pool kill failed: %s", e)

    def _record_pool_size(self) -> None:
        # TARGET size: handles held.  _spawn_actor's creation is async, so
        # the gauge (and timeline) lead the set of actually-running actors
        # by however long placement takes — documented in observability.md.
        n = len(self._actors)
        self.stats.pool_size = n
        self.stats.pool_size_peak = max(self.stats.pool_size_peak, n)
        self.stats.pool_size_timeline.append(n)
        fr.gauge(fr.DATA_POOL_SIZE, float(n), {"op": self.op_label})

    def _autoscale(self, now: float) -> None:
        if self._force_scale_up:
            # Remediation override: skip the streak hysteresis (the SLO
            # rule already judged the pressure sustained), keep the cap.
            self._force_scale_up = False
            if len(self._actors) < self.max_size:
                self._spawn_actor()
                self.stats.autoscale_up_events += 1
                fr.counter(fr.DATA_AUTOSCALE_EVENTS_TOTAL, 1.0,
                           {"op": self.op_label, "direction": "up"})
                self._record_pool_size()
        if now - self._last_autoscale < GlobalConfig.data_autoscale_interval_s:
            return
        self._last_autoscale = now
        saturated = self._actors and all(
            a.inflight >= self.max_in_flight for a in self._actors
        )
        if self.input and saturated and len(self._actors) < self.max_size:
            # Sustained pressure: two consecutive saturated checks, so one
            # momentary burst doesn't pay an actor launch.
            self._pressure_streak += 1
            if self._pressure_streak >= 2:
                self._pressure_streak = 0
                self._spawn_actor()
                self.stats.autoscale_up_events += 1
                fr.counter(fr.DATA_AUTOSCALE_EVENTS_TOTAL, 1.0,
                           {"op": self.op_label, "direction": "up"})
                self._record_pool_size()
        else:
            self._pressure_streak = 0
        if not self.input and len(self._actors) > self.min_size:
            idle_s = GlobalConfig.data_autoscale_idle_s
            for entry in [a for a in self._actors if a.inflight == 0]:
                if len(self._actors) <= self.min_size:
                    break
                if now - entry.idle_since >= idle_s:
                    self._kill_actor(entry)
                    self.stats.autoscale_down_events += 1
                    fr.counter(fr.DATA_AUTOSCALE_EVENTS_TOTAL, 1.0,
                               {"op": self.op_label, "direction": "down"})
                    self._record_pool_size()

    # -- scheduling --------------------------------------------------------
    def _buffered_out(self) -> int:
        return len(self.out) + len(self._completed)

    def inflight_refs(self):
        return self._inflight.keys()

    def step(self, sched) -> bool:
        if self.finished:
            return False
        progress = False
        now = time.perf_counter()
        while self.input and self._buffered_out() < self._out_bound:
            # Least-loaded dispatch (the old path striped round-robin and
            # could pile work behind one slow actor).
            entry = min(self._actors, key=lambda a: a.inflight, default=None)
            if entry is None or entry.inflight >= self.max_in_flight:
                break
            item, enq = self.input.popleft()
            self._mark_started()
            self.stats.add_queue_wait(time.perf_counter() - enq)
            ref = entry.handle.apply.remote(item)
            entry.inflight += 1
            self._inflight[ref] = (self._launch_seq, entry)
            self._launch_seq += 1
            self.stats.num_tasks += 1
            progress = True
        self._autoscale(now)
        self._gauge_queues()
        return self._maybe_finish() or progress

    def on_ready(self, ref) -> None:
        entry_seq = self._inflight.pop(ref, None)
        if entry_seq is None:
            return
        seq, entry = entry_seq
        entry.inflight -= 1
        if entry.inflight == 0:
            entry.idle_since = time.perf_counter()
        if self.ordered:
            self._completed[seq] = ref
            while self._emit_seq in self._completed:
                self._emit(self._completed.pop(self._emit_seq))
                self._emit_seq += 1
        else:
            self._emit(ref)
        self._maybe_finish()

    def _maybe_finish(self) -> bool:
        if (
            not self.finished
            and self.input_done
            and not self.input
            and not self._inflight
            and not self._completed
        ):
            self._teardown_pool()
            self._finish()
            return True
        return False

    def _teardown_pool(self) -> None:
        from ray_tpu_torch.util import remediation as _remediation

        _remediation.unregister_actuator(self._remediation_handle)
        for entry in list(self._actors):
            self._kill_actor(entry)
        self._record_pool_size()

    def cancel_remaining(self, sched) -> None:
        # Actor-task refs are not cancellable (only normal tasks are);
        # killing the pool aborts their execution instead.
        self._inflight.clear()
        self._completed.clear()
        self._teardown_pool()
        super().cancel_remaining(sched)


class _ShapeNode(_OpNode):
    """Dynamic block shaping before an exchange: split oversized map
    outputs, coalesce undersized runs — bounds per-task memory and
    shuffle fan-in skew.  Sizes come from the owner-side object records
    (no data fetch), so a block is shaped only once its task completed."""

    def __init__(self, target_bytes: int, options: ExecutionOptions,
                 stats_list: List[OpStats]):
        st = OpStats("ShapeBlocks")
        stats_list.append(st)
        super().__init__("ShapeBlocks", st)
        self.target = int(target_bytes)
        self.ordered = options.preserve_order
        self._pending: deque = deque()  # refs in input order
        self._ready: set = set()
        self._run: List[Any] = []  # undersized coalesce buffer
        self._run_bytes = 0

    def inflight_refs(self):
        return [r for r in self._pending if r not in self._ready]

    def step(self, sched) -> bool:
        progress = False
        while self.input:
            item, _enq = self.input.popleft()
            self._mark_started()
            ref = (
                item
                if isinstance(item, ray_tpu_torch.ObjectRef)
                else _run_block_ref(item)
            )
            self._pending.append(ref)
            progress = True
        progress |= self._drain()
        self._gauge_queues()
        return self._maybe_finish() or progress

    def on_ready(self, ref) -> None:
        self._ready.add(ref)
        self._drain()
        self._maybe_finish()

    def _drain(self) -> bool:
        progress = False
        if self.ordered:
            # Strict input order: only the head may be shaped, so the
            # emitted sequence is a deterministic function of the plan.
            while self._pending and self._pending[0] in self._ready:
                ref = self._pending.popleft()
                self._ready.discard(ref)
                self._process(ref)
                progress = True
        else:
            for ref in [r for r in self._pending if r in self._ready]:
                self._pending.remove(ref)
                self._ready.discard(ref)
                self._process(ref)
                progress = True
        return progress

    def _process(self, ref) -> None:
        size = ref_size_if_known(ref)
        if size is None or size == 0:
            self._flush_run()
            self._emit(ref)
            return
        if size > self.target:
            self._flush_run()
            k = min(int(math.ceil(size / self.target)), _MAX_SPLIT_FANOUT)
            if k <= 1:
                self._emit(ref)
                return
            refs = _split_block.options(num_returns=k).remote(ref, k)
            self.stats.num_tasks += 1
            self.stats.blocks_split += 1
            fr.counter(fr.DATA_BLOCKS_SPLIT_TOTAL, 1.0)
            for r in refs:
                self._emit(r)
            return
        if size < self.target // 2:
            self._run.append(ref)
            self._run_bytes += size
            if self._run_bytes >= self.target:
                self._flush_run()
            return
        self._flush_run()
        self._emit(ref)

    def _flush_run(self) -> None:
        if not self._run:
            return
        run, self._run = self._run, []
        self._run_bytes = 0
        if len(run) == 1:
            self._emit(run[0])
            return
        ref = _coalesce_blocks.remote(*run)
        self.stats.num_tasks += 1
        self.stats.blocks_coalesced += len(run)
        fr.counter(fr.DATA_BLOCKS_COALESCED_TOTAL, float(len(run)))
        self._emit(ref)

    def _maybe_finish(self) -> bool:
        if (
            not self.finished
            and self.input_done
            and not self.input
            and not self._pending
        ):
            self._flush_run()
            self._finish()
            return True
        return False

    def cancel_remaining(self, sched) -> None:
        _try_cancel(
            [r for r in self._pending if r not in self._ready], self.stats
        )
        self._pending.clear()
        self._ready.clear()
        self._run.clear()
        super().cancel_remaining(sched)


class _LimitNode(_OpNode):
    """Global row limit.  Signals the scheduler the moment it is
    satisfied so still-in-flight upstream work is cancelled (early-exit),
    not merely no longer launched.

    Never blocks the scheduler loop: input refs (and the remote count
    tasks of the hybrid path) sit in the shared in-flight set and are
    harvested like any other completion — a pending head (e.g. a
    straggler reduce ref out of a barrier) parks only this node, while
    other operators keep launching, harvesting, and autoscaling.  Blocks
    are consumed strictly in input order, so ``limit`` stays a
    deterministic prefix in ordered mode."""

    def __init__(self, stage: LimitStage, stats_list: List[OpStats]):
        st = OpStats(stage.name)
        stats_list.append(st)
        super().__init__(stage.name, st)
        self.remaining = stage.n
        self.satisfied = False
        self._pending: deque = deque()  # block refs in input order
        self._ready: set = set()
        self._counts: Dict[Any, Any] = {}  # block ref -> count-task ref

    def inflight_refs(self):
        refs = [r for r in self._pending if r not in self._ready]
        refs.extend(c for c in self._counts.values() if c not in self._ready)
        return refs

    def on_ready(self, ref) -> None:
        self._ready.add(ref)

    def step(self, sched) -> bool:
        if self.finished:
            return False
        progress = False
        while self.input and not self.satisfied:
            item, enq = self.input.popleft()
            self._mark_started()
            self.stats.add_queue_wait(time.perf_counter() - enq)
            self._pending.append(
                item
                if isinstance(item, ray_tpu_torch.ObjectRef)
                else _run_block_ref(item)
            )
            progress = True
        while self._pending and not self.satisfied:
            head = self._pending[0]
            if head not in self._ready:
                break
            # Hybrid counting (see _LIMIT_DRIVER_FETCH_MAX_BYTES): the
            # block is complete, so size it from the owner-side record to
            # pick driver get (small, shm-local) vs. remote count/trim.
            size = ref_size_if_known(head)
            if size is not None and size > _LIMIT_DRIVER_FETCH_MAX_BYTES:
                cnt = self._counts.get(head)
                if cnt is None:
                    self._counts[head] = _count_rows.remote(head)
                    break  # count in flight: harvested like any ref
                if cnt not in self._ready:
                    break
                del self._counts[head]
                self._ready.discard(cnt)
                n_rows, block = ray_tpu_torch.get(cnt, timeout=600), None
            else:
                block = ray_tpu_torch.get(head, timeout=600)
                n_rows = len(block)
            self._pending.popleft()
            self._ready.discard(head)
            self.stats.num_tasks += 1
            progress = True
            if n_rows <= self.remaining:
                self.remaining -= n_rows
                self._emit(head)
            elif block is not None:
                self._emit(ray_tpu_torch.put(block[: self.remaining]))
                self.remaining = 0
            else:
                self._emit(_trim_block.remote(head, self.remaining))
                self.remaining = 0
            if self.remaining <= 0:
                self.satisfied = True
                sched.on_limit_satisfied(self)
        return self._maybe_finish() or progress

    def _discard_pending(self) -> None:
        _try_cancel(
            [r for r in self._pending if r not in self._ready]
            + [c for c in self._counts.values() if c not in self._ready],
            self.stats,
        )
        self._pending.clear()
        self._ready.clear()
        self._counts.clear()

    def _maybe_finish(self) -> bool:
        if not self.finished and (
            self.satisfied
            or (self.input_done and not self.input and not self._pending)
        ):
            self.input.clear()
            self._discard_pending()
            self._finish()
            return True
        return False

    def cancel_remaining(self, sched) -> None:
        self._discard_pending()
        super().cancel_remaining(sched)


class _BarrierNode(_OpNode):
    """Internal-barrier stage (AllToAllStage / JoinStage / any plan node
    with ``.run``): absorbs its whole input, then launches the exchange
    and emits every output ref at once.  The stage's own generator
    appends its OpStats entry, so this node carries none."""

    def __init__(self, stage):
        super().__init__(stage.name, None)
        self.stage = stage
        self._collected: List[Any] = []
        self._ran = False

    def can_accept(self) -> bool:
        return True  # a barrier absorbs everything

    def step(self, sched) -> bool:
        progress = False
        while self.input:
            item, _enq = self.input.popleft()
            self._mark_started()
            self._collected.append(item)
            progress = True
        if self.input_done and not self._ran:
            self._ran = True
            # The stage generator launches the whole exchange as it is
            # drained; outputs are refs to not-yet-finished reduce tasks,
            # which downstream nodes harvest like any other completion.
            # Output refs are NOT retained here once propagated: pinning
            # every reduce output for the scheduler's lifetime would defeat
            # streaming memory release on large shuffles (the arena fills
            # while the consumer has long dropped the blocks).  Refs still
            # in self.out are cancelled by the base cancel_remaining;
            # refs already handed downstream are that node's to cancel.
            for ref in self.stage.run(iter(self._collected), sched.stats):
                self.out.append(ref)
            self._collected = []
            self.finished = True
            progress = True
        return progress

    def cancel_remaining(self, sched) -> None:
        self._collected = []
        super().cancel_remaining(sched)


# --------------------------------------------------------------- scheduler
class StreamingScheduler:
    """Drives the optimized plan's stages as an operator graph.

    One ``_step`` pass: (1) propagate blocks between queues (source →
    first node, each node's output → next node's input, bounded by
    ``can_accept``), (2) let every node launch under its backpressure
    policies, (3) harvest completed tasks across ALL nodes' in-flight
    sets — non-blocking when the pass made progress, a bounded blocking
    wait (recorded as straggler time) when it did not.
    """

    def __init__(self, inputs: List[Any], stages: List[Any],
                 stats: List[OpStats],
                 options: Optional[ExecutionOptions] = None):
        self.options = options or ExecutionOptions()
        self.stats = stats
        self.source: deque = deque(inputs)
        self.nodes: List[_OpNode] = []
        self._shut = False
        rm = (
            ResourceManager(n_ops=max(1, len(stages))) if stages else None
        )
        target = self.options.resolved_target_block_bytes()
        for stage in stages:
            if isinstance(stage, MapStage):
                if stage.compute is None:
                    node = _MapTaskNode(stage, self.options, rm, stats)
                else:
                    node = _ActorPoolNode(stage, self.options, stats)
            elif isinstance(stage, LimitStage):
                node = _LimitNode(stage, stats)
            else:  # barrier stage (exchange / join)
                if target > 0:
                    self.nodes.append(
                        _ShapeNode(target, self.options, stats)
                    )
                node = _BarrierNode(stage)
            self.nodes.append(node)

    # -- consumer-facing stream -------------------------------------------
    def run_stream(self) -> Iterator:
        if not self.nodes:
            # Plan with no stages (pre-materialized refs / raw blocks).
            yield from list(self.source)
            return
        from ray_tpu_torch.util import tracing

        # Root the stream's whole task fan-out in one trace so a dataset
        # execution exports as a single stitched cluster trace.  Detached
        # (not installed in the current context): a start_span block
        # entered here would leak its contextvar into the consumer between
        # yields.  A consumer that already has an active span wins — the
        # launches inherit it naturally and no extra root is made.
        root = None
        if GlobalConfig.enable_task_events and tracing.current_context() is None:
            root = tracing.detached_span(
                "data.stream",
                {"ops": ",".join(n.name for n in self.nodes)},
            )
        sink = self.nodes[-1]
        try:
            while True:
                while sink.out:
                    yield sink.out.popleft()
                if all(n.done for n in self.nodes):
                    break
                with tracing.span_context(root):
                    self._step()
        finally:
            if root is not None:
                tracing.finish_span(root)
            # Normal exhaustion: everything below is a no-op.  Abandoned
            # consumer (take() satisfied, generator closed): cancel all
            # remaining upstream work and tear down pools.
            self.shutdown()

    def _step(self) -> None:
        progress = self._propagate()
        for node in self.nodes:
            progress = node.step(self) or progress
        # A productive pass polls completions; an idle one parks on the
        # in-flight set in bounded slices so stragglers don't spin the
        # scheduler thread.
        harvested = self._harvest(
            may_block=not progress and not self.nodes[-1].out
        )
        if not progress and not harvested and not self.nodes[-1].out:
            if not any(True for n in self.nodes for _ in n.inflight_refs()) \
                    and not all(n.done for n in self.nodes):
                # No queued work, nothing in flight, not done: a wiring
                # bug.  Fail loudly — a silent busy-loop or hang would be
                # strictly worse.
                raise RuntimeError(
                    "streaming scheduler stalled: "
                    + "; ".join(
                        f"{n.name}(in={len(n.input)}, out={len(n.out)}, "
                        f"done={n.done})"
                        for n in self.nodes
                    )
                )

    def _propagate(self) -> bool:
        progress = False
        first = self.nodes[0]
        while self.source and first.can_accept():
            first.add_input(self.source.popleft())
            progress = True
        if not self.source and not first.input_done:
            first.mark_input_done()
            progress = True
        for up, down in zip(self.nodes, self.nodes[1:]):
            while up.out and down.can_accept():
                down.add_input(up.out.popleft())
                progress = True
            if up.done and not down.input_done:
                down.mark_input_done()
                progress = True
        return progress

    def _harvest(self, may_block: bool) -> bool:
        owner: Dict[Any, _OpNode] = {}
        for node in self.nodes:
            for ref in node.inflight_refs():
                owner[ref] = node
        if not owner:
            return False
        refs = list(owner)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        if not ready and may_block:
            t0 = time.perf_counter()
            ready, _ = ray_tpu_torch.wait(
                refs, num_returns=1,
                timeout=GlobalConfig.data_straggler_wait_slice_s,
            )
            dt = time.perf_counter() - t0
            if ready:
                node = owner[ready[0]]
                if node.stats is not None:
                    node.stats.straggler_wait_s += dt
            fr.histogram(fr.DATA_STRAGGLER_WAIT_HIST, dt)
        for ref in ready:
            owner[ref].on_ready(ref)
        return bool(ready)

    # -- early exit --------------------------------------------------------
    def on_limit_satisfied(self, limit_node: _LimitNode) -> None:
        """The limit is met: every task upstream of it is moot — cancel
        in-flight refs and tear down pools instead of letting ~all of a
        large read run to completion."""
        idx = self.nodes.index(limit_node)
        self.source.clear()
        for node in self.nodes[:idx]:
            node.cancel_remaining(self)
        limit_node.mark_input_done()

    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        self.source.clear()
        for node in self.nodes:
            if not node.done:
                node.cancel_remaining(self)
